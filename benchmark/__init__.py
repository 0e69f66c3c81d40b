"""The benchmark of the PyTorch / CUDA port (molclr_tpu_torch): run.py."""
