"""Build and load the port's CUDA kernels.

All ``ape_tpu_torch/csrc/*.cu`` sources compile with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and link
into one shared library with a plain C interface, loaded with ``ctypes``. The
library lives in ``build/ape_tpu_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the flags, the sources and the ``*.cuh`` headers they
include, so a changed file rebuilds and an unchanged build loads at once.
Nothing is compiled when a module is imported: the first kernel launch
builds. A failed build raises.

``host_library`` builds the host-side C++ sources (``csrc/*.cpp``: the JPEG
codec, the PNG unfilter, BMP's run lengths, GIF's LZW, the WebP decoder and
TIFF's LZW, PackBits and CCITT codecs, TGA's run lengths)
with the host compiler (``$CXX``, else ``c++``
or ``g++``) into a library of their own beside it, keyed the same way; it
needs no CUDA, so it builds and runs on any machine, the CPU-only one
included.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ape_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libape_tpu_torch_kernels.so"
HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
HOST_LIB_NAME = "libape_tpu_torch_host.so"

LAUNCHES = {"msda_fwd": 0, "msda_fwd_window": 0, "msda_bwd": 0, "msda_bwd_offatt": 0, "msda_bwd_value": 0,
            "attn_fwd": 0, "attn_bwd_dkv": 0, "attn_bwd_dq": 0,
            "msda_fwd_pair": 0, "msda_fwd_rows": 0, "msda_fwd_qlevel": 0, "msda_fwd_dense": 0,
            "msda_pair_probe": 0, "attn_fwd_tiles": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(flags, files) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build_dir() -> Path:
    # the sources and the headers they include
    return BUILD_ROOT / _digest(NVCC_FLAGS, sorted(CSRC.glob("*.cu*")))


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the library path."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in _sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if all(rc == 0 for _, _, rc in logs):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append((link, proc.stdout, proc.returncode))
    (out_dir / "nvcc.log").write_text("".join(f"{' '.join(cmd)}\n{out}" for cmd, out, _ in logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [(cmd, out, rc) for cmd, out, rc in logs if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f"kernel build failed ({rc}): {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ape_msda_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.ape_msda_fwd.restype = i
    # K1's window entry: value, offsets, att, shapes, starts, centers, sizes,
    # radius, first_query, out, B, S, Q, H, D, L, P, value_bf16, att_f32,
    # body, stream
    lib.ape_msda_fwd_window.argtypes = [p, p, p, p, p, p, p, f, i, p, i, i, i, i, i, i, i, i, i,
                                        i, p]
    lib.ape_msda_fwd_window.restype = i
    lib.ape_msda_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.ape_msda_bwd.restype = i
    lib.ape_msda_bwd_offatt.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.ape_msda_bwd_offatt.restype = i
    lib.ape_msda_bwd_value.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.ape_msda_bwd_value.restype = i
    lib.ape_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, f, i, p]
    lib.ape_attn_fwd.restype = i
    lib.ape_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.ape_attn_bwd_dkv.restype = i
    lib.ape_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.ape_attn_bwd_dq.restype = i
    # the window-MSDA forms (csrc/msda_window.cuh): value, offsets, att, out,
    # the int plan (host memory), radius, value_bf16, att_f32, stream
    for name in ("pair", "rows", "qlevel", "dense"):
        fn = getattr(lib, f"ape_msda_fwd_{name}")
        fn.argtypes = [p, p, p, p, ctypes.POINTER(i), f, i, i, p]
        fn.restype = i
    # K8's D = 32 body: value, offsets, att, grid centers, out, the int plan,
    # radius, value_bf16, att_f32, variant, stream
    lib.ape_msda_fwd_qlevel_d32.argtypes = [p, p, p, p, p, ctypes.POINTER(i), f, i, i, i, p]
    lib.ape_msda_fwd_qlevel_d32.restype = i
    # K6's and K7's D = 32 bodies: as K8's, without the variant
    for name in ("pair", "rows"):
        fn = getattr(lib, f"ape_msda_fwd_{name}_d32")
        fn.argtypes = [p, p, p, p, p, ctypes.POINTER(i), f, i, i, p]
        fn.restype = i
    # K9's D = 32 body: value (bf16), offsets, att, out, the int plan, radius,
    # att_f32, variant, stream
    lib.ape_msda_fwd_dense_d32.argtypes = [p, p, p, p, ctypes.POINTER(i), f, i, i, p]
    lib.ape_msda_fwd_dense_d32.restype = i
    # the probes: K10 (value, loc, att, out, B, Q, H, P, hv, wv, D, variant,
    # value_bf16, stream) and K11 (q, k, v, out, BH, N, DH, scale, is_bf16,
    # bq, bk, stream)
    lib.ape_msda_pair_probe.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.ape_msda_pair_probe.restype = i
    lib.ape_attn_fwd_tiles.argtypes = [p, p, p, p, i, i, i, f, i, i, i, p]
    lib.ape_attn_fwd_tiles.restype = i
    return lib


def _host_compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++): the host library needs one")


def host_build() -> Path:
    """Compile ``csrc/*.cpp`` (with the headers ``csrc/*.h`` they include)
    into the host library unless this exact build exists; return its path.
    A failed build raises."""
    sources = sorted(CSRC.glob("*.cpp"))
    out_dir = BUILD_ROOT / f"host-{_digest(HOST_FLAGS, sources + sorted(CSRC.glob('*.h')))}"
    lib = out_dir / HOST_LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{HOST_LIB_NAME}.{os.getpid()}"
    cmd = [_host_compiler(), *HOST_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out_dir / "c++.log").write_text(f"{' '.join(cmd)}\n{proc.stdout}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The loaded host library, built on first use. ctypes releases the GIL
    for each call, so threads decode and encode beside each other."""
    lib = ctypes.CDLL(str(host_build()))
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    out = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    # data, length, colour, out, width, height, channels, err, errlen
    lib.ape_jpeg_decode.argtypes = [p, size, i, out, ctypes.POINTER(i), ctypes.POINTER(i),
                                    ctypes.POINTER(i), ctypes.c_char_p, i]
    lib.ape_jpeg_decode.restype = i
    # pixels, width, height, channels, out, out_len, err, errlen
    lib.ape_jpeg_encode.argtypes = [p, i, i, i, out, ctypes.POINTER(size), ctypes.c_char_p, i]
    lib.ape_jpeg_encode.restype = i
    lib.ape_jpeg_free.argtypes = [p]
    lib.ape_jpeg_free.restype = None
    # PNG scanlines: data, height, stride, bytes a pixel, out
    lib.ape_png_unfilter.argtypes = [p, i, i, i, p]
    lib.ape_png_unfilter.restype = i
    # BMP run lengths: file, length, offset, rle4, width, height, out
    lib.ape_bmp_rle.argtypes = [p, size, size, i, i, i, p]
    lib.ape_bmp_rle.restype = i
    # GIF image data: file, length, offset, code size, interlace, width, height, out
    lib.ape_gif_lzw.argtypes = [p, size, size, i, i, i, i, p]
    lib.ape_gif_lzw.restype = i
    # GIF writer: RGB pixels, count, palette out, indices out; indices, width,
    # height, interlace, code size, out, capacity
    lib.ape_gif_quantize.argtypes = [p, size, p, p]
    lib.ape_gif_quantize.restype = i
    lib.ape_gif_lzw_encode.argtypes = [p, i, i, i, i, p, size]
    lib.ape_gif_lzw_encode.restype = ctypes.c_long
    # 8-bit resampling: in, in_w, in_h, channels, column starts, weights,
    # taps, out_w, row starts, weights, taps, out_h, out
    lib.ape_resample_u8.argtypes = [p, i, i, i, p, p, i, i, p, p, i, i, p]
    lib.ape_resample_u8.restype = i
    # WebP: data, length, out (RGBA), width, height, err, errlen
    lib.ape_webp_decode.argtypes = [p, size, out, ctypes.POINTER(i), ctypes.POINTER(i),
                                    ctypes.c_char_p, i]
    lib.ape_webp_decode.restype = i
    lib.ape_webp_free.argtypes = [p]
    lib.ape_webp_free.restype = None
    # WebP writer: RGB, width, height, out, size; the YUV planes alone
    lib.ape_webp_encode.argtypes = [p, i, i, out, ctypes.POINTER(size)]
    lib.ape_webp_encode.restype = i
    lib.ape_webp_enc_free.argtypes = [p]
    lib.ape_webp_enc_free.restype = None
    lib.ape_webp_yuv420.argtypes = [p, i, i, p, p, p]
    lib.ape_webp_yuv420.restype = None
    # TIFF strips: data, length, out, output bytes (LZW, PackBits); data,
    # length, compression, T4Options, width, rows, out (CCITT)
    for name in ("ape_tiff_lzw", "ape_tiff_packbits"):
        getattr(lib, name).argtypes = [p, size, p, size]
        getattr(lib, name).restype = i
    lib.ape_tiff_fax.argtypes = [p, size, i, i, i, i, p]
    lib.ape_tiff_fax.restype = i
    # TGA run lengths: file, length, offset, bytes a pixel, row bytes, rows, out
    lib.ape_tga_rle.argtypes = [p, size, size, i, size, size, p]
    lib.ape_tga_rle.restype = i
    # QOI: file, length, offset, channels, pixels, out; pixels, count,
    # channels, out
    lib.ape_qoi_decode.argtypes = [p, size, size, i, size, p]
    lib.ape_qoi_decode.restype = i
    lib.ape_qoi_encode.argtypes = [p, size, i, p]
    lib.ape_qoi_encode.restype = ctypes.c_long
    # PCX and Sun run lengths: file, length, offset, line bytes, rows, out;
    # PCX writer: lines, rows, line bytes, planes, padding, out
    for name in ("ape_pcx_rle", "ape_sun_rle"):
        getattr(lib, name).argtypes = [p, size, size, size, size, p]
        getattr(lib, name).restype = i
    lib.ape_pcx_encode.argtypes = [p, size, size, i, i, p]
    lib.ape_pcx_encode.restype = ctypes.c_long
    # SGI run lengths: file, length, bytes a sample, width, height, channels, out
    lib.ape_sgi_rle.argtypes = [p, size, i, i, i, i, p]
    lib.ape_sgi_rle.restype = i
    return lib


def ptxas_info(log: Path | None = None) -> dict:
    """Per compiled kernel (mangled name), what ``-Xptxas -v`` printed in the
    build's nvcc.log: {"registers", "spill_stores", "spill_loads"}."""
    text = (log or build_dir() / "nvcc.log").read_text()
    info, name = {}, None
    for line in text.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[1].strip()
            info[name] = {}
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            info[name]["spill_stores"] = int(words[words.index("spill") - 2])
            info[name]["spill_loads"] = int(words[words.index("loads") - 3])
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            info[name]["registers"] = int(words[words.index("Used") + 1])
            name = None
    return info


# SASS opcodes sass_counts counts: global loads and stores, tensor-core
# products (HMMA: mma.sync), shared-memory matrix loads (LDSM: ldmatrix),
# asynchronous global-to-shared copies (LDGSTS: cp.async), global
# reductions (REDG: an atomicAdd whose result is unused), atomics that
# return their result (ATOMG global, ATOM generic), shared-memory loads
# (LDS) and TMA loads (UTMALDG: cp.async.bulk.tensor); REDG_V4 counts the
# REDGs of four f32 lanes in one 16-byte access (REDG.E.ADD.F32x4: atomicAdd
# on float4, compute capability 9.x). LDG_<bits> counts the global loads by
# width: LDG.E.U16 16 bits, LDG.E 32, LDG.E.64 64, LDG.E.128 128; LDS_<bits>
# the shared-memory loads (LDS.U16, LDS, LDS.64, LDS.128), STG_<bits> the
# global stores (STG.E.U16, STG.E, STG.E.64, STG.E.128).
SASS_OPS = ("LDG", "STG", "HMMA", "LDSM", "LDGSTS", "REDG", "ATOMG", "ATOM", "LDS", "UTMALDG")
LDG_WIDTHS = ("LDG_8", "LDG_16", "LDG_32", "LDG_64", "LDG_128")
LDS_WIDTHS = ("LDS_8", "LDS_16", "LDS_32", "LDS_64", "LDS_128")
STG_WIDTHS = ("STG_8", "STG_16", "STG_32", "STG_64", "STG_128")
# every key of a function's counts (parse_sass)
SASS_KEYS = SASS_OPS + ("REDG_V4",) + LDG_WIDTHS + LDS_WIDTHS + STG_WIDTHS
_WIDTHS = tuple((kind, re.compile(rf"\b{kind}((?:\.[A-Z0-9_]+)*)\s"))
                for kind in ("LDG", "LDS", "STG"))


def ldg_width(modifiers: str) -> int:
    """Bits of a global or shared-memory load or a global store, from its
    opcode's modifiers (".E.64", ...)."""
    mods = set(modifiers.split("."))
    for bits in (128, 64):
        if str(bits) in mods:
            return bits
    if mods & {"U16", "S16"}:
        return 16
    return 8 if mods & {"U8", "S8"} else 32


def parse_sass(sass: str, pattern: str) -> dict:
    """Per function of a ``cuobjdump -sass`` listing whose mangled name holds
    ``pattern``: {name: {op: static count}} for the ops of ``SASS_OPS``,
    REDG_V4 and the widths of ``LDG_WIDTHS``, ``LDS_WIDTHS`` and
    ``STG_WIDTHS`` (``SASS_KEYS``)."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if pattern in name else None
            if name:
                counts[name] = dict.fromkeys(SASS_KEYS, 0)
        elif name:
            for op in SASS_OPS:
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
            if " REDG." in line and "x4." in line:
                counts[name]["REDG_V4"] += 1
            for kind, pat in _WIDTHS:
                m = pat.search(line)
                if m:
                    counts[name][f"{kind}_{ldg_width(m.group(1))}"] += 1
    return counts


@functools.lru_cache(maxsize=None)
def _sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library, disassembled once a process."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout


@functools.lru_cache(maxsize=None)
def _sass_functions(lib: Path) -> dict:
    """``parse_sass`` of every function of a built library, parsed once a
    process."""
    return parse_sass(_sass(lib), "")


def sass_counts(pattern: str) -> dict:
    """``parse_sass`` of the built library's SASS for the functions whose
    mangled name holds ``pattern``: static instructions, not executions."""
    return {name: dict(ops) for name, ops in _sass_functions(build()).items()
            if pattern in name}


def check(err: int, kernel: str) -> None:
    if err != 0:
        import torch

        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err} "
                           f"({torch.cuda.get_device_name()})")
