from .align import StillClassifier, VisionLanguageAlign, ZeroShotFC
from .common import FFN, MLP, LayerNorm, Linear, MultiheadAttention
from .msda_module import MultiScaleDeformableAttention
