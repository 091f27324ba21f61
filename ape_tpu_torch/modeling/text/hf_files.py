"""Read a Hugging Face model directory without ``transformers``,
``safetensors`` or ``tokenizers``.

A directory holds JSON (``config.json``, ``tokenizer_config.json``,
``special_tokens_map.json``, ``tokenizer.json``), a ``vocab.txt``, and the
weights: ``model.safetensors``, shards named by ``model.safetensors.index.json``,
or a ``pytorch_model.bin``. A safetensors file is an 8-byte little-endian
header length, a JSON header (each tensor's dtype, shape and byte range),
then the raw little-endian bytes; it is read from a private mapping of the
file, one tensor at a time, each copied straight into the model on its
device, so no weight is held twice in host memory.

Checkpoint names map to the port's modules as ``from_pretrained`` maps them
onto a base model: the base-model prefix stripped (``bert.``, ``model.``, T5's
``encoder.`` with ``shared`` as its embedding), what the base model does not
hold dropped (``cls.*``, the pooler, ``lm_head``, T5's decoder, the rotary
and position-id buffers), and the old ``LayerNorm.gamma``/``.beta`` renamed.
A weight the model holds and the checkpoint lacks raises, naming it.
"""

from __future__ import annotations

import json
import logging
import mmap
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("ape_tpu_torch")

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
# a header longer than this is not a safetensors file (the format's own cap)
MAX_HEADER_BYTES = 100_000_000

# JAX's tower kinds -> the checkpoints' model_type
MODEL_TYPES = {"bert": "bert", "t5": "t5", "llama2": "llama"}
# the base model's prefix in a checkpoint of a model with heads
_PREFIX = {"bert": "bert.", "llama2": "model.", "t5": "encoder."}
# checkpoint entries the base model does not hold (by prefix, after the
# base prefix is stripped, or by suffix)
_DROP_PREFIX = {"bert": ("cls.", "pooler."), "llama2": ("lm_head.",),
                "t5": ("decoder.", "lm_head.")}
_DROP_SUFFIX = {"bert": ("position_ids", "token_type_ids"), "llama2": ("rotary_emb.inv_freq",),
                "t5": ()}


def read_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_config(path) -> dict:
    """``config.json`` of the directory ``path``."""
    return read_json(Path(path) / "config.json")


def _token_content(value):
    """A special token as the tokenizer files give it: a string, or an
    ``AddedToken`` dict whose ``content`` is the string."""
    if isinstance(value, dict):
        return value["content"]
    return value


def read_tokenizer_config(path) -> dict:
    """``tokenizer_config.json`` with ``special_tokens_map.json`` over it
    (``from_pretrained`` lets the map's tokens win), every special token as
    its string; {} where the directory has neither."""
    d = Path(path)
    out = {}
    if (d / "tokenizer_config.json").is_file():
        out.update(read_json(d / "tokenizer_config.json"))
    if (d / "special_tokens_map.json").is_file():
        out.update(read_json(d / "special_tokens_map.json"))
    for k, v in list(out.items()):
        if k.endswith("_token"):
            out[k] = _token_content(v)
        elif k == "additional_special_tokens" and v is not None:
            out[k] = [_token_content(t) for t in v]
    return out


def pad_batch(seqs: Sequence[List[int]], pad_id: Optional[int], padding: str = "longest",
              max_length: Optional[int] = None, side: str = "right") -> Dict[str, np.ndarray]:
    """Token ids of each text to the tokenizers' batch: ``input_ids`` and
    ``attention_mask`` (int64), padded to the longest row or to
    ``max_length`` on ``side``, as a ``transformers`` tokenizer pads."""
    if padding not in ("longest", "max_length"):
        raise ValueError(f"padding {padding!r}: 'longest' or 'max_length'")
    if side not in ("left", "right"):
        raise ValueError(f"padding side {side!r}: 'left' or 'right'")
    if pad_id is None:
        raise ValueError("the tokenizer has no pad token (its files name none), and padding "
                         "needs one: set pad_token in tokenizer_config.json")
    width = max_length if padding == "max_length" else max((len(s) for s in seqs), default=0)
    if padding == "max_length" and width is None:
        raise ValueError("padding='max_length' needs max_length")
    width = max([width] + [len(s) for s in seqs])
    ids = np.full((len(seqs), width), pad_id, np.int64)
    mask = np.zeros((len(seqs), width), np.int64)
    for i, s in enumerate(seqs):
        if side == "right":
            ids[i, : len(s)], mask[i, : len(s)] = s, 1
        elif s:
            ids[i, -len(s):], mask[i, -len(s):] = s, 1
    return {"input_ids": ids, "attention_mask": mask}


class SafetensorsFile:
    """One ``.safetensors`` file: its header, and each tensor as a view of a
    private (copy-on-write) mapping of the file, which reads the bytes from
    the page cache and never writes the file."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            size = f.seek(0, 2)
            f.seek(0)
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: shorter than a safetensors header")
            n = int.from_bytes(head, "little")
            if n > min(MAX_HEADER_BYTES, size - 8):
                raise ValueError(f"{self.path}: header of {n} bytes in a file of {size}")
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
        self.metadata = header.pop("__metadata__", None) or {}
        self.header = header
        self._base = 8 + n
        self._size = size

    def names(self) -> List[str]:
        return list(self.header)

    def tensor(self, name: str) -> torch.Tensor:
        info = self.header[name]
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{self.path}: {name} has dtype {info['dtype']}, which the "
                                      f"reader does not take ({sorted(SAFETENSORS_DTYPES)})")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = int(np.prod(shape, dtype=np.int64))
        if end - begin != numel * itemsize or begin < 0 or self._base + end > self._size:
            raise ValueError(f"{self.path}: {name}'s byte range [{begin}, {end}) does not hold "
                             f"{shape} {info['dtype']} within the file")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        offset = self._base + begin
        if offset % itemsize:  # an unaligned tensor (old writers): copy its bytes
            return torch.frombuffer(bytearray(self._map[offset:offset + end - begin]),
                                    dtype=dtype).reshape(shape)
        return torch.frombuffer(self._map, dtype=dtype, count=numel, offset=offset).reshape(shape)


def checkpoint_files(path) -> Tuple[str, List[Path]]:
    """("safetensors" or "bin", the weight files) of the directory ``path``:
    ``model.safetensors``, else the shards ``model.safetensors.index.json``
    names, else ``pytorch_model.bin``."""
    d = Path(path)
    if (d / "model.safetensors").is_file():
        return "safetensors", [d / "model.safetensors"]
    if (d / "model.safetensors.index.json").is_file():
        weight_map = read_json(d / "model.safetensors.index.json")["weight_map"]
        return "safetensors", [d / f for f in sorted(set(weight_map.values()))]
    if (d / "pytorch_model.bin").is_file():
        return "bin", [d / "pytorch_model.bin"]
    raise FileNotFoundError(f"{d}: no model.safetensors, model.safetensors.index.json or "
                            "pytorch_model.bin")


def iter_checkpoint(path) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor on the host) of every weight of the directory ``path``,
    one at a time (safetensors: views of the mapped file; ``.bin``:
    ``torch.load`` with ``weights_only`` and ``mmap``)."""
    fmt, files = checkpoint_files(path)
    for f in files:
        if fmt == "bin":
            state = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
            for name in list(state):
                yield name, state.pop(name)
        else:
            st = SafetensorsFile(f)
            for name in st.names():
                yield name, st.tensor(name)


def model_key(kind: str, name: str) -> Optional[str]:
    """The port module's name of the checkpoint entry ``name`` of a
    ``kind`` tower ("bert", "t5", "llama2"), or None for an entry the base
    model does not hold."""
    if kind not in _PREFIX:
        raise KeyError(f"tower kind {kind!r}: one of {sorted(_PREFIX)}")
    if name.endswith("LayerNorm.gamma"):
        name = name[: -len("gamma")] + "weight"
    elif name.endswith("LayerNorm.beta"):
        name = name[: -len("beta")] + "bias"
    if kind == "t5" and name in ("shared.weight", "encoder.embed_tokens.weight"):
        return "embed_tokens.weight"
    prefix = _PREFIX[kind]
    if name.startswith(prefix):
        name = name[len(prefix):]
    if name.startswith(_DROP_PREFIX[kind]) or name.endswith(_DROP_SUFFIX[kind]):
        return None
    return name


def load_state(model: torch.nn.Module, entries: Iterable[Tuple[str, torch.Tensor]],
               kind: str) -> None:
    """Copy checkpoint ``entries`` (name, tensor) into ``model`` in place,
    each converted to the parameter's dtype on its device as it comes. A
    parameter no entry fills raises ``KeyError`` naming it; an entry the
    model does not hold is logged and skipped, as ``from_pretrained`` skips
    it."""
    targets = dict(model.state_dict(keep_vars=True))
    seen, unexpected = set(), []
    with torch.no_grad():
        for name, tensor in entries:
            key = model_key(kind, name)
            if key is None:
                continue
            if key not in targets:
                unexpected.append(name)
                continue
            dst = targets[key]
            if tuple(tensor.shape) != tuple(dst.shape):
                raise ValueError(f"{kind} checkpoint: {name} has shape {tuple(tensor.shape)}, "
                                 f"the model's {key} {tuple(dst.shape)}")
            dst.copy_(tensor)
            seen.add(key)
            del tensor
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"{kind} checkpoint lacks {len(missing)} weight(s) of the model: "
                       f"{missing[:8]}")
    if unexpected:
        logger.warning(f"{kind} checkpoint: {len(unexpected)} entries the model does not hold, "
                       f"skipped: {unexpected[:8]}")
