"""Native host library (ingest, pileup, model, emit, format, stats):
the C++ sources of this directory, compiled with g++ on first use.

The library lands in `bs_call_tpu_torch/build/<hash>/libbsc_ingest.so`,
where the hash covers the sources, the compile command and the host CPU
(`-march=native` makes the code CPU-specific and changes FP contraction),
so a library built from other sources or on another machine is never
loaded: it is rebuilt beside it. A failed build leaves `load()` returning
None, and the runner then takes the Python ingest path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "bsc_pool.cpp"),
    os.path.join(_DIR, "bsc_ingest.cpp"),
    os.path.join(_DIR, "bsc_pipeline.cpp"),
    os.path.join(_DIR, "bsc_format.cpp"),
    os.path.join(_DIR, "bsc_bgzf.cpp"),
    os.path.join(_DIR, "bsc_rans.cpp"),
    os.path.join(_DIR, "bsc_stats.cpp"),
    os.path.join(_DIR, "bsc_cram.cpp"),
    os.path.join(_DIR, "bsc_emit.cpp"),
    os.path.join(_DIR, "bsc_model.cpp"),
    os.path.join(_DIR, "bsc_rowengine.cpp"),
    os.path.join(_DIR, "bsc_dbsnp.cpp"),
]
_HDR = os.path.join(_DIR, "bsc_common.h")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
LIB_NAME = "libbsc_ingest.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _compile_cmd(out: str) -> list:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-o",
        out,
        *_SRCS,
        "-lz",
        "-pthread",
    ]
    # libdeflate (when present) takes over BGZF-block inflation only —
    # ~2-3x zlib on the input path; output compression stays zlib so
    # emitted BGZF/CRAM bytes are unchanged
    import ctypes.util

    if ctypes.util.find_library("deflate"):
        cmd[1:1] = ["-DBSC_USE_LIBDEFLATE"]
        cmd.append("-ldeflate")
    return cmd


def _host_cpu() -> str:
    """What `-march=native` resolves from: the CPU model and its feature
    flags (first processor of /proc/cpuinfo), else the platform name."""
    import platform

    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                if line.split(":")[0].strip() in (
                    "vendor_id", "model name", "flags", "Features",
                    "CPU implementer", "CPU part",
                ):
                    keep.append(line.strip())
    except OSError:
        pass
    return "\n".join(keep) or f"{platform.machine()} {platform.processor()}"


def lib_path() -> str:
    """Where this source tree's library lives on this CPU."""
    h = hashlib.sha256()
    h.update(" ".join(os.path.basename(c) for c in _compile_cmd("out"))
             .encode())
    h.update(_host_cpu().encode())
    for p in _SRCS + [_HDR]:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD, h.hexdigest()[:16], LIB_NAME)


def _build(so: str) -> bool:
    """Compile into a temporary directory beside `so` and rename: a
    concurrent process sees either no library or a complete one."""
    out_dir = os.path.dirname(so)
    try:
        os.makedirs(out_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=out_dir)
    except OSError:
        return False
    try:
        tmp_so = os.path.join(tmp, LIB_NAME)
        try:
            res = subprocess.run(_compile_cmd(tmp_so), capture_output=True,
                                 text=True, timeout=180)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if res.returncode != 0:
            import sys

            print(res.stderr, file=sys.stderr)
            return False
        os.replace(tmp_so, so)
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load():
    """Returns the ctypes library, building it if needed; None if the
    toolchain is unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = lib_path()
        if not os.path.exists(so) and not _build(so):
            _build_failed = True
            return None
        lib = ctypes.CDLL(so)
        lib.bsc_open.restype = ctypes.c_void_p
        lib.bsc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.bsc_close.argtypes = [ctypes.c_void_p]
        lib.bsc_n_refs.argtypes = [ctypes.c_void_p]
        lib.bsc_n_refs.restype = ctypes.c_int
        lib.bsc_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bsc_ref_name.restype = ctypes.c_char_p
        lib.bsc_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bsc_ref_len.restype = ctypes.c_int
        lib.bsc_header_text.argtypes = [ctypes.c_void_p]
        lib.bsc_header_text.restype = ctypes.c_char_p
        lib.bsc_next_batch.restype = ctypes.c_int
        lib.bsp_open.restype = ctypes.c_void_p
        lib.bsp_close.argtypes = [ctypes.c_void_p]
        lib.bsp_n_refs.argtypes = [ctypes.c_void_p]
        lib.bsp_n_refs.restype = ctypes.c_int
        lib.bsp_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bsp_ref_name.restype = ctypes.c_char_p
        lib.bsp_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bsp_ref_len.restype = ctypes.c_int
        lib.bsp_header_text.argtypes = [ctypes.c_void_p]
        lib.bsp_header_text.restype = ctypes.c_char_p
        lib.bsp_next_block.restype = ctypes.c_int
        lib.bsp_open_push.restype = ctypes.c_void_p
        lib.bsp_push.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
        ]
        lib.bsp_push_eof.argtypes = [ctypes.c_void_p]
        lib.bsp_set_partial.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.bsp_set_partial.restype = None
        lib.bsp_set_regions.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.bsp_set_regions.restype = ctypes.c_int
        lib.bsp_set_stream_regions.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.bsp_set_stream_regions.restype = ctypes.c_int
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.bsc_stats_acc_new.restype = ctypes.c_void_p
        lib.bsc_stats_acc_new.argtypes = [u8p, u8p, u8p, i32p, u8p, u8p,
                                          f64p]
        lib.bsc_stats_acc_free.argtypes = [ctypes.c_void_p]
        lib.bsc_stats_acc_cov.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, i32p, u8p, i64p, u8p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.bsc_stats_acc_cov.restype = None
        lib.bsc_stats_acc_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, i64p, i32p,
            i32p, i32p, i32p, i64p, i32p, i32p, i32p, u8p, u8p, i32p,
            i64p, u8p,
        ]
        lib.bsc_stats_acc_rows.restype = None
        lib.bsc_stats_acc_cov_size.restype = ctypes.c_int64
        lib.bsc_stats_acc_cov_size.argtypes = [ctypes.c_void_p]
        lib.bsc_stats_acc_cov_dump.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p, i64p, i64p,
        ]
        lib.bsc_stats_acc_cov_dump.restype = None
        lib.bsc_stats_acc_map_size.restype = ctypes.c_int64
        lib.bsc_stats_acc_map_size.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.bsc_stats_acc_map_dump.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, i64p,
        ]
        lib.bsc_stats_acc_map_dump.restype = None
        lib.bsc_stats_acc_fixed.argtypes = [
            ctypes.c_void_p, i64p, i64p, f64p, i64p, i64p, i64p,
        ]
        lib.bsc_stats_acc_fixed.restype = None
        lib.bsc_stats_acc_nctg.restype = ctypes.c_int64
        lib.bsc_stats_acc_nctg.argtypes = [ctypes.c_void_p]
        lib.bsc_stats_acc_ctg_dump.argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.bsc_stats_acc_ctg_dump.restype = None
        lib.bsc_model_new.restype = ctypes.c_void_p
        lib.bsc_model_new.argtypes = [
            ctypes.c_int64, f64p, f64p, f64p, f64p, f64p,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.bsc_model_free.argtypes = [ctypes.c_void_p]
        lib.bsc_model_call.restype = None
        lib.bsc_model_call.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, i32p, i32p, i32p,
            ctypes.c_int32, f64p, i32p, f64p, f64p,
        ]
        lib.bsp_set_sam_mode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
        ]
        lib.bsp_set_sam_mode.restype = None
        lib.bsp_set_ref_lens.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32
        ]
        lib.bsp_set_ref_lens.restype = None
        lib.bsp_block_reads_size.restype = None
        lib.bsp_block_reads_size.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.bsp_block_reads.restype = None
        lib.bsp_block_reads.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64,
        ] + [ctypes.c_void_p] * 5
        lib.bsc_emit_prep.restype = None
        lib.bsc_emit_prep.argtypes = [ctypes.c_int64] + [
            ctypes.c_void_p
        ] * 25
        lib.bsc_format_rows.restype = ctypes.c_int64
        lib.bsc_format_bcf.restype = ctypes.c_int64
        # row engine (bsc_rowengine.cpp): whole-block host fast path
        lib.bsre_new.restype = ctypes.c_void_p
        lib.bsre_new.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 16
            + [ctypes.c_int]
        )
        lib.bsre_free.argtypes = [ctypes.c_void_p]
        lib.bsre_set_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.bsre_set_stats.restype = None
        lib.bsre_load.restype = None
        lib.bsre_load.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.bsre_model.restype = ctypes.c_int64
        lib.bsre_model.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.bsre_ties.restype = None
        lib.bsre_ties.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, i32p, i32p, i32p,
        ]
        lib.bsre_fix.restype = None
        lib.bsre_fix.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, i64p,
            f64p, i32p,
        ]
        lib.bsre_emit.restype = ctypes.c_int64
        lib.bsre_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, u8p, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, u8p, ctypes.c_void_p, ctypes.c_int64,
        ]
        # dbSNP contig decode and rs names (bsc_dbsnp.cpp)
        lib.bsc_dbsnp_load.restype = ctypes.c_void_p
        lib.bsc_dbsnp_load.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p, i32p,
        ]
        lib.bsc_dbsnp_take.restype = None
        lib.bsc_dbsnp_take.argtypes = [ctypes.c_void_p] * 6
        lib.bsc_dbsnp_free.restype = None
        lib.bsc_dbsnp_free.argtypes = [ctypes.c_void_p]
        lib.bsc_dbsnp_names.restype = None
        lib.bsc_dbsnp_names.argtypes = [ctypes.c_int64] + [
            ctypes.c_void_p
        ] * 9
        lib.bsc_bgzf_deflate_batch.restype = ctypes.c_int64
        lib.bsc_rans_decode_o0.restype = ctypes.c_int64
        lib.bsc_rans_decode_o1.restype = ctypes.c_int64
        lib.bsc_fisher_batch.restype = None
        lib.bsc_fisher_batch.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.bsc_cram_decode_slice.restype = ctypes.c_int64
        lib.bsc_cram_decode_slice.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # comp header
            ctypes.c_void_p, ctypes.c_int64,   # core block
            ctypes.c_int32, ctypes.c_void_p,   # n_ext, ids
            ctypes.c_void_p, ctypes.c_void_p,  # offs, blob
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ref/start/nrec
            ctypes.c_void_p, ctypes.c_int64,   # ref codes
            ctypes.c_void_p, ctypes.c_int64,   # out
        ]
        lib.bsc_cram_decode_slice_mref.restype = ctypes.c_int64
        lib.bsc_cram_decode_slice_mref.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # comp header
            ctypes.c_void_p, ctypes.c_int64,   # core block
            ctypes.c_int32, ctypes.c_void_p,   # n_ext, ids
            ctypes.c_void_p, ctypes.c_void_p,  # offs, blob
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ref/start/nrec
            ctypes.c_int32, ctypes.c_void_p,   # n_refs, tids
            ctypes.c_void_p, ctypes.c_void_p,  # ref offs, ref blob
            ctypes.c_void_p, ctypes.c_int64,   # out
        ]
        _lib = lib
        return _lib
