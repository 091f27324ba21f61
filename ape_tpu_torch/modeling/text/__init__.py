from .clip_openai import (
    CLIPTEXT,
    TextModel,
    build_clip_text_encoder,
    build_openclip_text_encoder,
    get_clip_embeddings,
    get_openclip_embeddings,
)
from .clip_text import CLIPTextTransformer
from .tokenizer import BPETokenizer, HashTokenizer, get_tokenizer
from .wrapper import EVA02CLIP, reduce_language_feature
