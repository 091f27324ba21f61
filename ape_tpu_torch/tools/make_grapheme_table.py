"""Write ``ape_tpu_torch/modeling/text/grapheme_table.py``, the classes that
``graphemes`` segments by, from the ``regex`` module's Unicode data, held
against the ``tokenizers`` package's own segmentation:

    python3 -m ape_tpu_torch.tools.make_grapheme_table [--check]

Both packages are used as data here only; the port imports neither. Each
code point gets its Grapheme_Cluster_Break value, its Indic_Conjunct_Break
value and its Extended_Pictographic flag from ``regex``. ``regex`` may
follow a later Unicode version than the ``unicode-segmentation`` crate
inside ``tokenizers``; where they disagree, ``tokenizers`` decides. Its
segmentation shows through the ``Precompiled`` normalizer, which looks a
grapheme of fewer than 6 UTF-8 bytes up whole: a charsmap whose only key is
"a" rewrites "a" + c to "A" exactly when c joins the "a" before it (Extend,
ZWJ, SpacingMark); one keyed by every lead byte rewrites c + "a" to one
"X" exactly when c joins the "a" after it (Prepend); one keyed by U+0600
(a Prepend) rewrites U+0600 + c to "X" unless c is a Control, CR or LF.
``probe`` builds these three strings over every code point, and
``derive`` moves each code point whose class disagrees with them: to Other
(no InCB) where ``regex`` joins and ``tokenizers`` does not, to Extend,
Prepend or Control where only ``tokenizers`` joins or breaks. A pair of 6
bytes or more is never looked up whole, so the probe cannot see (and the
normalizer never depends on) the classes that only join such pairs: the
Hangul jamo, regional indicators, GB9c's conjuncts and GB11's emoji
sequences keep ``regex``'s values.

``--check`` writes nothing and exits 1 if the shipped table differs from
the one derived now.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from ape_tpu_torch.modeling.text import graphemes as G
from ape_tpu_torch.modeling.text.charsmap import Charsmap, build_charsmap

TABLE = Path(__file__).resolve().parents[1] / "modeling" / "text" / "grapheme_table.py"
N_CODE_POINTS = 0x110000
PREPEND_PROBE = "؀"


def code_points() -> List[int]:
    """Every code point but the surrogates (no Python string of UTF-8
    holds them)."""
    return [c for c in range(N_CODE_POINTS) if not 0xD800 <= c < 0xE000]


def regex_classes() -> Dict[int, int]:
    """{code point: class} of every code point whose class is not Other,
    from ``regex``'s property tables."""
    import regex

    out: Dict[int, int] = {}
    text = "".join(map(chr, code_points()))
    for value, name in enumerate(G.GCB_NAMES):
        if value:
            for m in regex.finditer(r"\p{Grapheme_Cluster_Break=%s}" % name, text):
                out[ord(m.group())] = value
    for bits, name in G.INCB_NAMES.items():
        for m in regex.finditer(r"\p{Indic_Conjunct_Break=%s}" % name, text):
            out[ord(m.group())] = out.get(ord(m.group()), 0) | bits
    for m in regex.finditer(r"\p{Extended_Pictographic}", text):
        out[ord(m.group())] = out.get(ord(m.group()), 0) | G.PICTOGRAPHIC
    return out


def probe_maps(cps: Sequence[int]) -> Dict[str, Tuple[bytes, List[str]]]:
    """{probe: (charsmap blob, the lines it normalizes)}, a line for each
    code point of ``cps`` (LF, which separates the lines, is left out)."""
    lead = {bytes([b]): "X" for b in list(range(1, 128)) + list(range(0xC2, 0xF5))
            if b not in (ord("a"), ord("\n"))}
    chars = [chr(c) for c in cps]
    return {
        "after": (build_charsmap({"a": "A"}), ["a" + c for c in chars]),
        "before": (build_charsmap(lead), [c + "a" for c in chars]),
        "control": (build_charsmap({PREPEND_PROBE: "X"}), [PREPEND_PROBE + c for c in chars]),
    }


def probe_code_points() -> List[int]:
    return [c for c in code_points() if c != 0x0A]


def probe(cps: Sequence[int]) -> Dict[str, List[str]]:
    """{probe: the lines of ``cps`` as ``tokenizers``' ``Precompiled``
    normalizes them}."""
    from tokenizers import normalizers

    return {name: normalizers.Precompiled(blob).normalize_str("\n".join(lines)).split("\n")
            for name, (blob, lines) in probe_maps(cps).items()}


def port_outputs(classes: Dict[int, int], cps: Sequence[int]) -> Dict[str, List[str]]:
    """The lines of ``cps`` as the port's ``Charsmap`` normalizes them under
    ``classes``."""
    saved = G._cache.copy()
    G._cache.clear()
    G._cache.update({chr(c): classes.get(c, 0) for c in code_points()})
    try:
        return {name: Charsmap(blob).normalize("\n".join(lines)).split("\n")
                for name, (blob, lines) in probe_maps(cps).items()}
    finally:
        G._cache.clear()
        G._cache.update(saved)


def disagreements(classes: Dict[int, int], cps: Sequence[int]) -> Dict[str, List[int]]:
    """{probe: the code points of ``cps`` whose lines ``classes``
    normalizes otherwise than ``tokenizers`` does}."""
    want, got = probe(cps), port_outputs(classes, cps)
    return {name: [cps[i] for i, (g, w) in enumerate(zip(got[name], want[name])) if g != w]
            for name in want}


def derive() -> Dict[int, int]:
    """The table's classes: ``regex``'s, moved where ``tokenizers``'
    probe disagrees (see the module), then every moved code point probed
    again (a line holds one code point, so the others stand)."""
    classes = regex_classes()
    fixes = {"after": G.EXTEND, "before": G.PREPEND, "control": G.CONTROL}
    moved = set()
    for name, cps in disagreements(classes, probe_code_points()).items():
        for c in cps:
            gcb = classes.get(c, 0) & 15
            joins = {"after": gcb in (G.EXTEND, G.ZWJ, G.SPACING_MARK),
                     "before": gcb == G.PREPEND,
                     "control": gcb in (G.CR, G.LF, G.CONTROL)}[name]
            new = G.OTHER if joins else fixes[name]
            classes[c] = new | (classes.get(c, 0) & G.PICTOGRAPHIC)
            if not classes[c]:
                del classes[c]
            moved.add(c)
    left = {k: v for k, v in disagreements(classes, sorted(moved)).items() if v}
    if left:
        raise RuntimeError(f"the grapheme classes still disagree with tokenizers: "
                           f"{ {k: [hex(c) for c in v[:8]] for k, v in left.items()} }")
    return classes


def runs(classes: Dict[int, int]) -> Tuple[List[int], List[int]]:
    """(start, class) of each run of equal classes over 0..0x10FFFF."""
    starts, values = [0], [classes.get(0, 0)]
    for c in range(1, N_CODE_POINTS):
        v = classes.get(c, 0)
        if v != values[-1]:
            starts.append(c)
            values.append(v)
    return starts, values


def render(classes: Dict[int, int]) -> str:
    starts, values = runs(classes)

    def rows(xs, per=12):
        return "\n".join("    " + ", ".join(str(x) for x in xs[i:i + per]) + ","
                         for i in range(0, len(xs), per))

    return (
        '"""The grapheme classes of every code point, in runs: the run that\n'
        "starts at ``RUN_START[i]`` has class ``RUN_CLASS[i]`` (Grapheme_Cluster_Break\n"
        "in bits 0-3, Indic_Conjunct_Break in bits 4-5, Extended_Pictographic in\n"
        "bit 6; see ``graphemes``). Written by\n"
        "``python3 -m ape_tpu_torch.tools.make_grapheme_table``; do not edit.\"\"\"\n\n"
        f"RUN_START = (\n{rows(starts)}\n)\n\nRUN_CLASS = (\n{rows(values, 24)}\n)\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="compare with the shipped table only")
    args = ap.parse_args(argv)
    text = render(derive())
    if args.check:
        same = TABLE.read_text(encoding="utf-8") == text
        print("the shipped table is current" if same else "the shipped table differs")
        return 0 if same else 1
    TABLE.write_text(text, encoding="utf-8")
    print(f"wrote {TABLE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
