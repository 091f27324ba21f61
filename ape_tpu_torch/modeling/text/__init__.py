from .clip_openai import (
    CLIPTEXT,
    TextModel,
    build_clip_text_encoder,
    build_openclip_text_encoder,
    get_clip_embeddings,
    get_openclip_embeddings,
)
from .bert import BertModel
from .bpe import HFBPETokenizer
from .clip_text import CLIPTextTransformer
from .hf_wrappers import (
    T5,
    Bert,
    Llama2,
    agg_lang_feat,
    build_hf_text_model,
    build_tower,
    init_tower,
    load_tokenizer,
    load_tower,
)
from .llama import LlamaModel
from .t5 import T5Encoder
from .tokenizer import BPETokenizer, HashTokenizer, get_tokenizer
from .wordpiece import WordPieceTokenizer
from .wrapper import EVA02CLIP, reduce_language_feature
