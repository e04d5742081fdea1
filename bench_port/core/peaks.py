"""Published peaks of one NVIDIA H100 SXM 80 GB at its 700 W limit
(NVIDIA's data sheet, dense rates).  Frozen from chip_smoke.py."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # float32 outside the tensor cores; the port
#                          runs float32 with TF32 off
