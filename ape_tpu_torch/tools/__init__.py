"""Measurement scripts for the port, run on a CUDA card from the root of a
checkout (``python3 -m ape_tpu_torch.tools.<name>``)."""
