"""``tokenizers``' ``Precompiled`` normalizer (sentencepiece's
``precompiled_charsmap``, read as the ``spm_precompiled`` crate reads it),
and a writer of such maps.

The map is one blob: 4 bytes little-endian, the size in bytes of a
darts-clone double array; the array's 32-bit little-endian units; then the
normalized strings, each ending in a NUL. A unit holds its label in bits
0-7, "has a leaf" in bit 8, and the offset to its children in bits 10-31
(shifted up by 8 more when bit 9 is set); a leaf unit sets bit 31 and holds
its value, the byte offset of a normalized string, in bits 0-30.

``transform(s)`` runs darts-clone's common-prefix search over the bytes of
``s`` and takes the FIRST (shortest) key that is a prefix of it: so a lookup
of a whole grapheme may rewrite all of it through a key that covers only its
first characters. ``normalize`` goes grapheme by grapheme (``graphemes``): a
grapheme of fewer than 6 UTF-8 bytes is looked up whole; otherwise, or when
that finds nothing, each of its characters alone, an unmatched one kept.
``transformations`` gives the same result as the (character, change) list
``tokenizers`` hands to ``NormalizedString::transform``, so the alignment
can follow it (``hf_pipeline``).
"""

from __future__ import annotations

import base64
from typing import Dict, List, Optional, Tuple

import numpy as np

from ape_tpu_torch.modeling.text.graphemes import graphemes

_LEAF_BIT = 1 << 31
_HAS_LEAF = 1 << 8
_MAX_OFFSET = 1 << 21  # the offsets this writer encodes without bit 9


def _offset(unit: int) -> int:
    return (unit >> 10) << ((unit & (1 << 9)) >> 6)


class Charsmap:
    """A ``precompiled_charsmap``: ``transform``, ``normalize`` and
    ``transformations``. A blob that is too short, or whose strings are not
    UTF-8, raises ``ValueError``."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError(f"precompiled_charsmap of {len(blob)} bytes: shorter than its header")
        size = int.from_bytes(blob[:4], "little")
        if 4 + size > len(blob):
            raise ValueError(f"precompiled_charsmap: a trie of {size} bytes in a blob of "
                             f"{len(blob)}")
        self.units = np.frombuffer(blob[4:4 + size - size % 4], "<u4").astype(np.int64).tolist()
        self.strings = blob[4 + size:]
        self.strings.decode("utf-8")  # raises on a blob that is not UTF-8, as the crate does
        self._cache: Dict[str, Optional[str]] = {}

    @classmethod
    def from_base64(cls, text: str) -> "Charsmap":
        return cls(base64.b64decode(text))

    def _search(self, key: bytes) -> Optional[int]:
        """The value of the shortest key that is a prefix of ``key``
        (darts-clone's common-prefix search, its first result)."""
        units = self.units
        pos = _offset(units[0])
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                raise ValueError("precompiled_charsmap: the trie points past its end")
            unit = units[pos]
            if unit & (_LEAF_BIT | 0xFF) != c:
                return None
            pos ^= _offset(unit)
            if unit & _HAS_LEAF:
                return units[pos] & (_LEAF_BIT - 1)
        return None

    def transform(self, s: str) -> Optional[str]:
        """The normalized string the map gives ``s`` (see the module), or
        None."""
        if s not in self._cache:
            value = self._search(s.encode("utf-8"))
            if value is None:
                self._cache[s] = None
            else:
                end = self.strings.find(b"\0", value)
                self._cache[s] = self.strings[value:end if end >= 0 else None].decode("utf-8")
        return self._cache[s]

    def transformations(self, text: str) -> Optional[List[Tuple[str, int]]]:
        """``tokenizers``' (character, change) list for ``text``, or None
        where no lookup matched (the string is left as it is)."""
        out: List[Tuple[str, int]] = []
        modified = False
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    modified = True
                    _replace(out, g, norm)
                    continue
            for c in g:
                norm = self.transform(c)
                if norm is not None:
                    modified = True
                    _replace(out, c, norm)
                else:
                    out.append((c, 0))
        return out if modified else None

    def normalize(self, text: str) -> str:
        steps = self.transformations(text)
        return text if steps is None else "".join(c for c, _ in steps)


def _replace(out: List[Tuple[str, int]], old: str, new: str) -> None:
    """``spm_precompiled``'s ``replace``: the new characters, the last ones
    marked as inserted where there are more of them, or the removed count
    put on the last character so far where there are fewer."""
    diff = len(new) - len(old)
    out.extend((c, 0) for c in new)
    if diff > 0:
        for i in range(len(out) - diff, len(out)):
            out[i] = (out[i][0], 1)
    elif diff < 0 and out:
        out[-1] = (out[-1][0], out[-1][1] + diff)


def _next_free(used: bytearray, start: int) -> int:
    """The first unused unit at or after ``start`` (past the end if none)."""
    i = used.find(0, start)
    return max(len(used), start) if i < 0 else i


def build_charsmap(mapping: Dict[str, str]) -> bytes:
    """A ``precompiled_charsmap`` blob of ``mapping`` (non-empty key, a
    string or raw bytes such as a lone UTF-8 lead byte -> normalized string,
    no NUL in either): a darts-clone double array packed
    so that children share 256-unit blocks with other nodes, every offset
    under 2^21 units."""
    items = sorted((k if isinstance(k, bytes) else k.encode("utf-8"), v)
                   for k, v in mapping.items())
    keys = [k for k, _ in items]
    strings, value = bytearray(), {}
    for k, v in items:
        if not k or b"\0" in k or "\0" in v:
            raise ValueError(f"charsmap key {k!r}: empty, or a NUL in it or its string")
        value[k] = len(strings)
        strings += v.encode("utf-8") + b"\0"
    # the trie: node -> ({byte: child}, value or None)
    root: tuple = ({}, None)
    nodes_of = {b"": root}
    for k in keys:
        for i in range(1, len(k) + 1):
            if k[:i] not in nodes_of:
                nodes_of[k[:i]] = ({}, None)
                nodes_of[k[:i - 1]][0][k[i - 1]] = nodes_of[k[:i]]
        nodes_of[k] = (nodes_of[k][0], value[k])
        parent = nodes_of[k[:-1]]
        parent[0][k[-1]] = nodes_of[k]
    units = [0] * 256
    used = bytearray(256)
    used[0] = 1
    bases = set()
    first_free = 1

    def free(p: int) -> bool:
        return p >= len(used) or not used[p]

    queue = [(root, 0)]
    for node, pos in queue:
        children, val = node
        labels = sorted(children) + ([0] if val is not None else [])
        first_free = _next_free(used, first_free)
        q = first_free
        while True:  # the lowest base whose child slots are all free
            base = q ^ labels[0]
            if base not in bases and all(free(base ^ c) for c in labels):
                break
            q = _next_free(used, q + 1)
        top = (base | 0xFF) + 1  # the base's whole 256-unit block, so any byte stays inside
        if top > len(units):
            units += [0] * (top - len(units))
            used += bytearray(top - len(used))
        offset = base ^ pos
        if offset >= _MAX_OFFSET:
            raise ValueError(f"charsmap: an offset of {offset} units (at most {_MAX_OFFSET - 1})")
        bases.add(base)
        units[pos] |= (offset << 10) | (_HAS_LEAF if val is not None else 0)
        if val is not None:
            units[base] = _LEAF_BIT | val
            used[base] = 1
        for c in sorted(children):
            units[base ^ c] = c
            used[base ^ c] = 1
            queue.append((children[c], base ^ c))
    trie = np.asarray(units, "<u4").tobytes()
    return len(trie).to_bytes(4, "little") + trie + bytes(strings)
