"""Host-side float64 numpy oracle: the subset of the JAX package's
oracle that training needs."""
