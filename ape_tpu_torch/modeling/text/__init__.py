from .clip_text import CLIPTextTransformer
from .tokenizer import BPETokenizer, HashTokenizer, get_tokenizer
from .wrapper import EVA02CLIP, reduce_language_feature
