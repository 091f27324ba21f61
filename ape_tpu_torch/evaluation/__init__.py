"""The host side of evaluation (counterpart of ``ape_tpu/evaluation/``):
the panoptic merge, the semantic, panoptic and referring evaluators, PIL's
bilinear resizes in NumPy, and the per-image semantic and panoptic steps.
NumPy only: no PIL, no cv2 and nothing of ``ape_tpu``."""
