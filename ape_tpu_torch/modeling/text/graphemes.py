"""Extended grapheme clusters (Unicode UAX #29, the rules of its 15.1 and
16.0 editions) as the ``unicode-segmentation`` crate inside ``tokenizers``
splits a string, for the ``Precompiled`` normalizer (``charsmap``).

Each code point's classes come from ``grapheme_table`` (written by
``ape_tpu_torch/tools/make_grapheme_table.py``): its Grapheme_Cluster_Break
value, its Indic_Conjunct_Break value (InCB) and whether it is
Extended_Pictographic. The rules, in their order of precedence:

- GB3-GB5: CR x LF; a break after and before every Control, CR and LF;
- GB6-GB8: the Hangul syllable sequences (L, V, T, LV, LVT);
- GB9, GB9a, GB9b: no break before Extend, ZWJ or SpacingMark, nor after
  Prepend;
- GB9c: InCB Consonant [InCB Extend | Linker]* InCB Linker
  [InCB Extend | Linker]* x InCB Consonant (Indic conjuncts);
- GB11: Extended_Pictographic Extend* ZWJ x Extended_Pictographic (emoji
  ZWJ sequences);
- GB12, GB13: regional indicators in pairs;
- GB999: a break everywhere else.
"""

from __future__ import annotations

import bisect
from typing import Dict, List

from ape_tpu_torch.modeling.text.grapheme_table import RUN_CLASS, RUN_START

# Grapheme_Cluster_Break values (the low 4 bits of a class)
OTHER, CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING_MARK, L, V, T, LV, LVT = range(14)
GCB_NAMES = ("Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator", "Prepend",
             "SpacingMark", "L", "V", "T", "LV", "LVT")
# InCB values (bits 4-5) and Extended_Pictographic (bit 6)
INCB_LINKER, INCB_CONSONANT, INCB_EXTEND = 1 << 4, 2 << 4, 3 << 4
INCB_NAMES = {INCB_LINKER: "Linker", INCB_CONSONANT: "Consonant", INCB_EXTEND: "Extend"}
INCB_MASK = 3 << 4
PICTOGRAPHIC = 1 << 6

_CONTROLS = (CR, LF, CONTROL)
_cache: Dict[str, int] = {}


def table_class(ch: str) -> int:
    """The class of the character ``ch`` in the shipped table."""
    cls = _cache.get(ch)
    if cls is None:
        cls = RUN_CLASS[bisect.bisect_right(RUN_START, ord(ch)) - 1]
        _cache[ch] = cls
    return cls


def _joined(prev: int, cur: int, ri_run: int, emoji: int, conjunct: int) -> bool:
    """No break between a character of class ``prev`` and one of ``cur``;
    ``ri_run`` counts the regional indicators that end at ``prev``,
    ``emoji`` is 2 just after ExtPict Extend* ZWJ, ``conjunct`` 2 just
    after GB9c's left side."""
    p, c = prev & 15, cur & 15
    if p == CR and c == LF:
        return True
    if p in _CONTROLS or c in _CONTROLS:
        return False
    if p == L and c in (L, V, LV, LVT):
        return True
    if p in (LV, V) and c in (V, T):
        return True
    if p in (LVT, T) and c == T:
        return True
    if c in (EXTEND, ZWJ, SPACING_MARK) or p == PREPEND:
        return True
    if conjunct == 2 and cur & INCB_MASK == INCB_CONSONANT:
        return True
    if emoji == 2 and cur & PICTOGRAPHIC:
        return True
    return p == RI and c == RI and ri_run % 2 == 1


def graphemes(text: str) -> List[str]:
    """``text`` split into its extended grapheme clusters."""
    if text.isascii() and "\r" not in text:  # no ASCII character joins another but CR LF
        return list(text)
    out: List[str] = []
    start = 0
    prev = ri_run = emoji = conjunct = 0
    for i, ch in enumerate(text):
        cur = table_class(ch)
        if i and not _joined(prev, cur, ri_run, emoji, conjunct):
            out.append(text[start:i])
            start = i
        gcb, incb = cur & 15, cur & INCB_MASK
        ri_run = ri_run + 1 if gcb == RI else 0
        if cur & PICTOGRAPHIC:
            emoji = 1
        elif emoji == 1 and gcb == EXTEND:
            emoji = 1
        elif emoji == 1 and gcb == ZWJ:
            emoji = 2
        else:
            emoji = 0
        if incb == INCB_CONSONANT:
            conjunct = 1
        elif conjunct and incb == INCB_LINKER:
            conjunct = 2
        elif not (conjunct and incb == INCB_EXTEND):
            conjunct = 0
        prev = cur
    if text:
        out.append(text[start:])
    return out
