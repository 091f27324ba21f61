from .attention import global_attention
from .box_ops import box_cxcywh_to_xyxy
from .misc import inverse_sigmoid
from .msda import level_start_index, ms_deform_attn
from .msda_dispatch import ms_deform_attn_exact, ms_deform_attn_window
from .nms import batched_nms_mask, nms_mask
from .posemb import position_embedding_sine
