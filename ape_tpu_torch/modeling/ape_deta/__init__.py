from .model import APEDeta, ChannelMapper, level_valid_masks
from .postprocess import instance_inference
from .transformer import (
    DeformableDetrTransformer,
    DeformableTransformerDecoder,
    DeformableTransformerEncoder,
)
