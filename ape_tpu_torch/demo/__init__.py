"""The prompted demo (counterpart of the repository's ``demo/``):
``predictor_lazy.VisualizationDemo`` and the CLI ``python -m
ape_tpu_torch.demo.demo_lazy``."""
