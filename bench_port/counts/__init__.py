"""Work and bytes counted from shapes, for the roofline and utilisation
metrics: the same whatever implements the detector."""
