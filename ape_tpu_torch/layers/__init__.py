from .align import VisionLanguageAlign
from .common import FFN, MLP, LayerNorm, Linear, MultiheadAttention
from .msda_module import MultiScaleDeformableAttention
