"""ctypes bindings + lazy build for the C++ entropy front-end.

The library is built on first use (g++ -O3 -march=native) into
native/build/, keyed on its sources and the host (native/buildkey.py); the
VLC table header is generated from vlc_tables.py so both front-ends share
one source of truth.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .buildkey import build_key, is_current, mark_current
from ..types import (
    BitstreamExhausted,
    H263Error,
    InternalDecoderError,
    InvalidBitstream,
    InvalidIntraDc,
    InvalidLongCoefficient,
    InvalidMacroblockCodedBits,
    InvalidMacroblockHeader,
    InvalidMvd,
    InvalidShortCoefficient,
    MotionVectorRange,
    Picture,
    PictureOption,
    PictureTypeCode,
    UncodedIFrameBlocks,
    UnimplementedDecoding,
)

_DIR = os.path.dirname(os.path.abspath(__file__))


def _pick_build_dir() -> str:
    """native/build/ next to the sources when writable (the repo case) or
    when it already holds a built library (image built as root, run as a
    different user: reuse it read-only); otherwise a per-user cache dir
    (read-only site-packages installs).  Never raises — an unusable cache
    dir just means _build() later fails and ensure_built() returns False
    (the documented pure-Python degradation)."""
    d = os.path.join(_DIR, "build")
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".writable")
        with open(probe, "w"):
            pass
        os.unlink(probe)
        return d
    except OSError:
        pass
    if os.path.exists(os.path.join(d, "libh263entropy.so")):
        return d  # prebuilt, read-only: loaded if its stamp fits this host
    base = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "h263_tpu", "build")


_BUILD_DIR = _pick_build_dir()
_LIB_PATH = os.path.join(_BUILD_DIR, "libh263entropy.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fastcall = None  # optional CPython marshalling helper (see _build_fastcall)
NATIVE_AVAILABLE: Optional[bool] = None  # resolved on first ensure_built()

_ERROR_MAP = {
    -100: BitstreamExhausted,
    -1: InternalDecoderError,
    -2: InvalidMacroblockHeader,
    -3: InvalidMacroblockCodedBits,
    -4: InvalidIntraDc,
    -5: InvalidShortCoefficient,
    -6: InvalidLongCoefficient,
    -7: InvalidMvd,
    -8: UncodedIFrameBlocks,
    -9: UnimplementedDecoding,
    -10: InvalidBitstream,
}

_PICTURE_TYPE_CODE = {
    PictureTypeCode.I_FRAME: 0,
    PictureTypeCode.P_FRAME: 1,
    PictureTypeCode.DISPOSABLE_P_FRAME: 2,
}

F_SORENSON = 1
F_HAS_PLUSPTYPE = 2
F_UMV_OPTION = 4
F_MV_RANGE_EXTENDED = 8
F_PACK_DELTA24 = 16


_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]


def _build(force: bool = False) -> bool:
    """Make _LIB_PATH a library of the current sources built on this host.

    The stamp next to the library (native/buildkey.py) holds a hash of the
    source, the generated VLC header, the compile flags and the host CPU;
    a library with any other stamp — e.g. a build directory copied from
    another machine, compiled there with -march=native — is rebuilt, and
    `force` rebuilds unconditionally."""
    tables_h = os.path.join(_DIR, "tables.h")
    src = os.path.join(_DIR, "entropy.cpp")
    vlc_src = os.path.join(os.path.dirname(_DIR), "vlc_tables.py")

    def fresh(p):
        return os.path.exists(p) and (
            os.path.getmtime(p) >= os.path.getmtime(vlc_src))

    try:
        if not fresh(tables_h):
            if os.access(_DIR, os.W_OK):
                from . import gen_tables

                gen_tables.main(tables_h)
            else:
                # Read-only install: regenerate in the build dir and
                # compile a copy of the source from there, so the quoted
                # include resolves to the fresh header (the including
                # file's directory is searched first).
                import shutil

                os.makedirs(_BUILD_DIR, exist_ok=True)
                tables_h = os.path.join(_BUILD_DIR, "tables.h")
                if not fresh(tables_h):
                    from . import gen_tables

                    gen_tables.main(tables_h)
                src2 = os.path.join(_BUILD_DIR, "entropy.cpp")
                shutil.copyfile(src, src2)
                src = src2
        with open(src, "rb") as f_src, open(tables_h, "rb") as f_tab:
            key = build_key(f_src.read(), f_tab.read(),
                            " ".join(_CXX_FLAGS).encode())
        if not force and is_current(_LIB_PATH, key):
            return True
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_CXX_FLAGS, src, "-o", tmp],
                       check=True, capture_output=True,
                       cwd=os.path.dirname(src))
        os.replace(tmp, _LIB_PATH)
        mark_current(_LIB_PATH, key)
        return True
    except Exception:
        return False


def _build_fastcall(force: bool = False):
    """Build/load the optional CPython marshalling helper (h263_fastcall).

    Returns the module or None; every caller has a ctypes fallback."""
    import importlib.util
    import sysconfig

    src = os.path.join(_DIR, "fastcall.cpp")
    tag = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    path = os.path.join(_BUILD_DIR, "h263_fastcall" + tag)
    try:
        include = sysconfig.get_paths()["include"]
        cmd = ["g++", "-O2", "-shared", "-fPIC", f"-I{include}", src]
        with open(src, "rb") as f:
            key = build_key(f.read(), " ".join(cmd).encode())
        if force or not is_current(path, key):
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run([*cmd, "-o", tmp], check=True,
                           capture_output=True, cwd=_DIR)
            os.replace(tmp, path)
            mark_current(path, key)
        spec = importlib.util.spec_from_file_location("h263_fastcall", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:
        # The ctypes fallback costs ~170 us/step at n=256; make losing the
        # fast path observable instead of silent.
        from ..utils.trace import incr

        incr("fastcall_build_failed")
        return None


def ensure_built(force_rebuild: bool = False) -> bool:
    """Build/load the native library; returns availability.

    `force_rebuild` compiles the library (and the fastcall helper) from
    the sources on this host even if a current build exists; it must be
    asked for before anything in the process has loaded the library."""
    global _lib, _fastcall, NATIVE_AVAILABLE
    with _lock:
        if NATIVE_AVAILABLE is not None and not force_rebuild:
            return NATIVE_AVAILABLE
        if force_rebuild and _lib is not None:
            raise RuntimeError("native library already loaded; a forced "
                               "rebuild would not take effect")
        if not _build(force=force_rebuild):
            NATIVE_AVAILABLE = False
            return False
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.h263_parse_frame.restype = ctypes.c_int
            lib.h263_abi_version.restype = ctypes.c_int
            assert lib.h263_abi_version() == 6
            _lib = lib
            NATIVE_AVAILABLE = True
            if not os.environ.get("H263_TPU_NO_FASTCALL"):
                _fastcall = _build_fastcall(force=force_rebuild)
        except Exception:
            NATIVE_AVAILABLE = False
        return NATIVE_AVAILABLE


def fastcall_loaded() -> bool:
    """True once the CPython marshalling helper is loaded."""
    return _fastcall is not None


def _mv_ranges(picture: Picture, width: int, height: int) -> tuple[int, int]:
    """Extended-UMV half-pel ranges keyed to picture dims
    (mvd_pred.rs:94-109, incl. the band-gap fallthrough)."""
    def rx(dim):
        if 0 <= dim <= 352:
            return 64
        if 356 <= dim <= 704:
            return 128
        if 708 <= dim <= 1408:
            return 256
        if dim >= 1412:
            return 512
        return 64

    def ry(dim):
        if 0 <= dim <= 288:
            return 64
        if 292 <= dim <= 576:
            return 128
        if dim >= 580:
            return 256
        return 64

    return rx(width), ry(height)


def parse_frame_native(data: bytes, start_bit: int, picture: Picture,
                       decoder_options, running_options: PictureOption,
                       width: int, height: int, out=None):
    """Native equivalent of parser.frame.parse_frame.

    Takes the raw buffer + the bit position where macroblock data begins.
    Returns a FrameData (same layout/dtypes as the Python front-end) plus
    the final bit position.

    `out` may be a tuple of preallocated C-contiguous arrays
    (coeffs_y, class_y, coeffs_cb, class_cb, coeffs_cr, class_cr, mvs,
    inter-as-uint8) — e.g. one stream's slice of a batch buffer — which the
    parser fills in place (they are reset here), avoiding a copy.
    """
    from ..parser.frame import FrameData
    from ..types import DecoderOption

    assert _lib is not None, "call ensure_built() first"

    mb_w = -(-width // 16)
    mb_h = -(-height // 16)
    nmb = mb_w * mb_h

    if out is not None:
        (coeffs_y, class_y, coeffs_cb, class_cb, coeffs_cr, class_cr,
         mvs, inter) = out
        for a in out:
            assert a.flags["C_CONTIGUOUS"], "out buffers must be C-contiguous"
        coeffs_y[:] = 0
        class_y[:] = 0
        coeffs_cb[:] = 0
        class_cb[:] = 0
        coeffs_cr[:] = 0
        class_cr[:] = 0
        mvs[:] = 0
        inter[:] = 1
    else:
        coeffs_y = np.zeros((2 * mb_h, 2 * mb_w, 8, 8), dtype=np.int16)
        class_y = np.zeros((2 * mb_h, 2 * mb_w), dtype=np.int8)
        coeffs_cb = np.zeros((mb_h, mb_w, 8, 8), dtype=np.int16)
        class_cb = np.zeros((mb_h, mb_w), dtype=np.int8)
        coeffs_cr = np.zeros((mb_h, mb_w, 8, 8), dtype=np.int16)
        class_cr = np.zeros((mb_h, mb_w), dtype=np.int8)
        mvs = np.zeros((mb_h, mb_w, 4, 2), dtype=np.int16)
        inter = np.ones((mb_h, mb_w), dtype=np.uint8)
    pred_scratch = np.zeros((nmb, 4, 2), dtype=np.int16)

    flags = 0
    if decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
        flags |= F_SORENSON
    if picture.has_plusptype:
        flags |= F_HAS_PLUSPTYPE
    if running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS:
        flags |= F_UMV_OPTION
    if picture.motion_vector_range is MotionVectorRange.EXTENDED:
        flags |= F_MV_RANGE_EXTENDED

    ptype = _PICTURE_TYPE_CODE.get(picture.picture_type, 3)
    rx, ry = _mv_ranges(picture, width, height)

    end_bit = ctypes.c_uint64(0)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = _lib.h263_parse_frame(
        buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(len(data)),
        ctypes.c_uint64(start_bit),
        ctypes.c_int32(width), ctypes.c_int32(height),
        ctypes.c_int32(ptype), ctypes.c_int32(flags),
        ctypes.c_int32(picture.version if picture.version is not None else -1),
        ctypes.c_int32(picture.quantizer),
        ctypes.c_int32(rx), ctypes.c_int32(ry),
        coeffs_y.ctypes.data_as(ctypes.c_void_p),
        class_y.ctypes.data_as(ctypes.c_void_p),
        coeffs_cb.ctypes.data_as(ctypes.c_void_p),
        class_cb.ctypes.data_as(ctypes.c_void_p),
        coeffs_cr.ctypes.data_as(ctypes.c_void_p),
        class_cr.ctypes.data_as(ctypes.c_void_p),
        mvs.ctypes.data_as(ctypes.c_void_p),
        inter.ctypes.data_as(ctypes.c_void_p),
        pred_scratch.ctypes.data_as(ctypes.c_void_p),
        None, None, ctypes.c_int32(0), None,
        ctypes.byref(end_bit), None,
        None, None, ctypes.c_int32(0), None,  # fused/flag outputs unused
    )
    if rc != 0:
        exc = _ERROR_MAP.get(rc, InternalDecoderError)
        raise exc(f"native parse error {rc}")

    frame = FrameData(
        picture=picture, width=width, height=height, mb_w=mb_w, mb_h=mb_h,
        coeffs_y=coeffs_y, class_y=class_y,
        coeffs_cb=coeffs_cb, class_cb=class_cb,
        coeffs_cr=coeffs_cr, class_cr=class_cr,
        mvs=mvs, inter=inter.astype(np.bool_),
    )
    return frame, int(end_bit.value)


def parse_frame_native_packed(data: bytes, start_bit: int, picture: Picture,
                              decoder_options,
                              running_options: PictureOption,
                              width: int, height: int,
                              pack_pos: np.ndarray, mvs: np.ndarray,
                              inter: np.ndarray, pred_scratch: np.ndarray,
                              pack_val: Optional[np.ndarray] = None,
                              transport: str = "u32",
                              mvs_slim: Optional[np.ndarray] = None):
    """Like parse_frame_native, but emits the packed coefficient transport
    (combined-u32 into pack_pos when pack_val is None, else split int32
    positions + int16 values) for any header flavor — used by the batched
    standard-H.263 path, whose picture headers parse in Python.

    Fills mvs/inter in place; returns (count, end_bit).  The caller owns
    sentinel-padding of unused pack entries."""
    from ..types import DecoderOption

    assert _lib is not None, "call ensure_built() first"

    mvs[:] = 0
    inter[:] = 1

    flags = 0
    if decoder_options & DecoderOption.SORENSON_SPARK_BITSTREAM:
        flags |= F_SORENSON
    if picture.has_plusptype:
        flags |= F_HAS_PLUSPTYPE
    if running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS:
        flags |= F_UMV_OPTION
    if picture.motion_vector_range is MotionVectorRange.EXTENDED:
        flags |= F_MV_RANGE_EXTENDED
    if transport == "d24":
        assert pack_val is None and pack_pos.dtype == np.uint8
        flags |= F_PACK_DELTA24
        cap = pack_pos.shape[0] // 3
    else:
        cap = pack_pos.shape[0]

    ptype = _PICTURE_TYPE_CODE.get(picture.picture_type, 3)
    rx, ry = _mv_ranges(picture, width, height)

    end_bit = ctypes.c_uint64(0)
    count = ctypes.c_int32(0)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = _lib.h263_parse_frame(
        buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(len(data)),
        ctypes.c_uint64(start_bit),
        ctypes.c_int32(width), ctypes.c_int32(height),
        ctypes.c_int32(ptype), ctypes.c_int32(flags),
        ctypes.c_int32(picture.version if picture.version is not None else -1),
        ctypes.c_int32(picture.quantizer),
        ctypes.c_int32(rx), ctypes.c_int32(ry),
        None, None, None, None, None, None,
        mvs.ctypes.data_as(ctypes.c_void_p),
        inter.ctypes.data_as(ctypes.c_void_p),
        pred_scratch.ctypes.data_as(ctypes.c_void_p),
        pack_pos.ctypes.data_as(ctypes.c_void_p),
        pack_val.ctypes.data_as(ctypes.c_void_p)
        if pack_val is not None else None,
        ctypes.c_int32(cap),
        ctypes.byref(count),
        ctypes.byref(end_bit),
        mvs_slim.ctypes.data_as(ctypes.c_void_p)
        if mvs_slim is not None else None,
        None, None, ctypes.c_int32(0), None,  # fused/flag outputs unused
    )
    if rc != 0:
        exc = _ERROR_MAP.get(rc, InternalDecoderError)
        raise exc(f"native packed parse error {rc}")
    return int(count.value), int(end_bit.value)


class PackOverflow(H263Error):
    """Packed-coefficient capacity exceeded; caller should fall back to the
    dense transport for this frame."""


_ERROR_MAP[-11] = PackOverflow


def _setup_fast_sig(lib):
    import ctypes as C

    lib.h263_sorenson_decode_frame.restype = C.c_int
    lib.h263_sorenson_decode_frame.argtypes = [
        C.c_char_p, C.c_uint64,            # data, nbytes
        C.c_int32, C.c_int32,              # expected w, h
        C.c_int32,                         # xflags (transport)
        C.c_void_p,                        # hdr_fields
        C.c_void_p, C.c_void_p,            # mvs, mvs_slim
        C.c_void_p, C.c_void_p,            # inter, pred_scratch
        C.c_void_p, C.c_void_p, C.c_int32,   # pack_pos, pack_val, cap
        C.c_void_p, C.c_void_p,              # pack_count, any_inter
        C.c_void_p,                          # end_bit
        C.c_void_p, C.c_void_p, C.c_int32,   # mv8, inter_bits, mv8_stride
    ]


class SorensonFastParser:
    """Minimal-overhead per-stream-slot parser handle.

    Binds fixed output buffers (one stream's slices of the packed batch)
    once, so each frame parse is a single ctypes call with pre-marshalled
    pointers.  Returns the parsed header fields.
    """

    __slots__ = ("_args", "_hdr", "_count", "_any_inter", "_end", "_cap",
                 "_w", "_h")

    def __init__(self, width: int, height: int, pack_u32: np.ndarray,
                 mvs: np.ndarray, inter: np.ndarray,
                 pred_scratch: np.ndarray):
        assert _lib is not None
        if not hasattr(_lib, "_fast_sig_done"):
            _setup_fast_sig(_lib)
            _lib._fast_sig_done = True
        mb_w, mb_h = -(-width // 16), -(-height // 16)
        # Combined (pos<<12 | val) transport needs 20-bit positions.
        assert 6 * mb_w * mb_h * 64 < (1 << 20), \
            "picture too large for combined packed transport"
        assert pack_u32.dtype == np.int32 and pack_u32.flags["C_CONTIGUOUS"]
        self._hdr = np.zeros(8, dtype=np.int32)
        self._count = ctypes.c_int32(0)
        self._any_inter = ctypes.c_int32(0)
        self._end = ctypes.c_uint64(0)
        self._cap = int(pack_u32.shape[0])
        self._w, self._h = width, height
        self._args = (
            width, height, 0,  # xflags: the slot parser stays u32
            self._hdr.ctypes.data,
            mvs.ctypes.data, None, inter.ctypes.data, pred_scratch.ctypes.data,
            pack_u32.ctypes.data, None, self._cap,
            ctypes.addressof(self._count), ctypes.addressof(self._any_inter),
            ctypes.addressof(self._end),
            None, None, 0,  # fused outputs unused by the slot parser
        )

    def parse(self, data: bytes):
        """Parse one frame.

        Returns (hdr_fields int32[8], n_coeffs, any_inter, any_varied_mvs).
        hdr_fields: [version, tr, width, height, ptype_code, deblocker,
        quant, fmt_code].  any_varied_mvs is False when every macroblock's
        four block MVs are identical (slim MV transport is exact).
        """
        rc = _lib.h263_sorenson_decode_frame(data, len(data), *self._args)
        if rc != 0:
            exc = _ERROR_MAP.get(rc, InternalDecoderError)
            if rc == -10:
                from ..types import PictureFormatInvalid

                raise PictureFormatInvalid("native fast parse: bad format/dims")
            raise exc(f"native fast parse error {rc}")
        flags = int(self._any_inter.value)
        return self._hdr, int(self._count.value), bool(flags & 1), bool(flags & 2)


def _setup_batch_sig(lib):
    import ctypes as C

    lib.h263_sorenson_decode_batch.restype = C.c_int
    lib.h263_sorenson_decode_batch.argtypes = [
        C.c_void_p, C.c_void_p,              # buffers (ptr array), lengths
        C.c_int32, C.c_int32, C.c_int32,     # n, w, h
        C.c_int32,                           # xflags (transport)
        C.c_void_p,                          # has_reference
        C.c_void_p, C.c_void_p,              # hdr_all, mvs_all
        C.c_void_p, C.c_void_p,              # mvs_slim_all, inter_all
        C.c_void_p,                          # pred_scratch
        C.c_void_p, C.c_void_p, C.c_int32,   # pack_all, packval_all, cap
        C.c_void_p, C.c_void_p,              # counts, flags
        C.c_void_p,                          # failed_stream
    ]


class SorensonBatchParser:
    """One-FFI-call-per-step batch parser bound to a _PackedBatch's buffers."""

    __slots__ = ("_n", "_w", "_h", "_cap", "_xflags", "_hdr", "_counts",
                 "_flags", "_failed", "_lengths", "_has_ref", "_ptrs",
                 "_fixed_args")

    def __init__(self, n: int, width: int, height: int, pack_pos: np.ndarray,
                 mvs: np.ndarray, inter: np.ndarray, pred_scratch: np.ndarray,
                 pack_val: np.ndarray = None, transport: str = "u32",
                 mvs_slim: np.ndarray = None):
        """transport "u32": pack_pos int32 [n, cap], combined
        (position<<12 | value), needs 6*mb_w*mb_h*64 < 2^20.
        transport "split" (pack_val given): int32 positions + int16 values.
        transport "d24": pack_pos uint8 [n, 3*cap], delta-coded 24-bit
        entries (any picture size)."""
        assert _lib is not None
        if not hasattr(_lib, "_batch_sig_done"):
            _setup_batch_sig(_lib)
            _lib._batch_sig_done = True
        mb_w, mb_h = -(-width // 16), -(-height // 16)
        if transport == "d24":
            assert pack_val is None
            assert pack_pos.dtype == np.uint8 and pack_pos.shape[1] % 3 == 0
        elif pack_val is None:
            assert 6 * mb_w * mb_h * 64 < (1 << 20)
        else:
            transport = "split"
            assert pack_val.shape == pack_pos.shape
            assert pack_val.dtype == np.int16
        assert pack_pos.shape[0] == n and mvs.shape[0] == n
        self._n, self._w, self._h = n, width, height
        self._cap = int(pack_pos.shape[1] // (3 if transport == "d24" else 1))
        self._xflags = F_PACK_DELTA24 if transport == "d24" else 0
        self._hdr = np.zeros((n, 8), dtype=np.int32)
        self._counts = np.zeros(n, dtype=np.int32)
        self._flags = np.zeros(n, dtype=np.int32)
        self._failed = ctypes.c_int32(-1)
        self._lengths = np.zeros(n, dtype=np.uint64)
        self._has_ref = np.zeros(n, dtype=np.uint8)
        self._ptrs = np.zeros(n, dtype=np.uint64)
        self._fixed_args = (
            self._n, self._w, self._h, self._xflags,
            self._has_ref.ctypes.data,
            self._hdr.ctypes.data, mvs.ctypes.data,
            mvs_slim.ctypes.data if mvs_slim is not None else None,
            inter.ctypes.data,
            pred_scratch.ctypes.data,
            pack_pos.ctypes.data,
            pack_val.ctypes.data if pack_val is not None else None,
            self._cap,
            self._counts.ctypes.data, self._flags.ctypes.data,
            ctypes.addressof(self._failed),
        )

    def parse(self, buffers, has_reference):
        """Parse all streams' frames.

        buffers: sequence of n bytes objects; has_reference: bool per
        stream.  Returns (hdr int32[n,8], counts, flags) — flags bit0 =
        any_inter, bit1 = varied MVs.  Raises the mapped error (with the
        failing stream index in the message) on any failure.
        """
        n = self._n
        assert len(buffers) == n
        if _fastcall is not None:
            # one C pass fills pointer + length arrays (~us); the ctypes
            # element-wise conversion below costs ~170 us at n=256
            _fastcall.gather_ptrs(buffers, self._ptrs.ctypes.data,
                                  self._lengths.ctypes.data)
            ptrs_addr = self._ptrs.ctypes.data
            keepalive = buffers
        else:
            keepalive = (ctypes.c_char_p * n)(*buffers)
            self._lengths[:] = [len(b) for b in buffers]
            ptrs_addr = ctypes.addressof(keepalive)
        self._has_ref[:] = has_reference
        rc = _lib.h263_sorenson_decode_batch(
            ptrs_addr, self._lengths.ctypes.data, *self._fixed_args)
        del keepalive
        if rc != 0:
            exc = _ERROR_MAP.get(rc, InternalDecoderError)
            raise exc(f"stream {int(self._failed.value)}: native error {rc}")
        return self._hdr, self._counts, self._flags


def _setup_fused_batch_sig(lib):
    import ctypes as C

    lib.h263_sorenson_decode_batch_fused.restype = C.c_int
    lib.h263_sorenson_decode_batch_fused.argtypes = [
        C.c_void_p, C.c_void_p,              # buffers (ptr array), lengths
        C.c_int32, C.c_int32, C.c_int32,     # n, w, h
        C.c_int32,                           # xflags
        C.c_void_p,                          # has_reference
        C.c_void_p, C.c_void_p, C.c_void_p,  # hdr_all, mvs_all, inter_all
        C.c_void_p, C.c_int64, C.c_int32,    # fused_base, row_bytes, mv8_stride
        C.c_void_p,                          # pred_scratch
        C.c_int32,                           # pack_cap
        C.c_void_p, C.c_int32,               # ladder, n_ladder
        C.c_void_p, C.c_void_p, C.c_void_p,  # counts, flags, cut_out
        C.c_void_p,                          # failed_stream
    ]


class SorensonFusedBatchParser:
    """One-FFI-call batch parser emitting the fused single-leaf transport.

    The native side writes each stream's int8 MVs + INTER bitmask + delta24
    coefficients into one row of `fused` (uint8 [n, row]), picks the
    coefficient transfer bucket from `ladder`, and pads d24 tails only up
    to it.  `mvs`/`inter` still receive the full int16 MVs / byte flags —
    the fallback source for the step on which varied block MVs first
    appear while rows carry slim (2 B/MB) MVs.
    """

    __slots__ = ("_n", "_w", "_h", "_cap", "_hdr", "_counts", "_flags",
                 "_failed", "_cut", "_lengths", "_has_ref", "_ptrs",
                 "_fixed_args")

    def __init__(self, n: int, width: int, height: int, fused: np.ndarray,
                 mv8_stride: int, mvs: np.ndarray, inter: np.ndarray,
                 pred_scratch: np.ndarray, pack_cap: int,
                 ladder: np.ndarray):
        assert _lib is not None
        if not hasattr(_lib, "_fused_sig_done"):
            _setup_fused_batch_sig(_lib)
            _lib._fused_sig_done = True
        mb_w, mb_h = -(-width // 16), -(-height // 16)
        nmb = mb_w * mb_h
        row = nmb * mv8_stride + (nmb + 7) // 8 + 3 * pack_cap
        assert fused.dtype == np.uint8 and fused.flags["C_CONTIGUOUS"]
        assert fused.shape == (n, row), (fused.shape, (n, row))
        assert mv8_stride in (2, 8)
        assert ladder.dtype == np.int32 and int(ladder[-1]) == pack_cap
        self._n, self._w, self._h = n, width, height
        self._cap = pack_cap
        self._hdr = np.zeros((n, 8), dtype=np.int32)
        self._counts = np.zeros(n, dtype=np.int32)
        self._flags = np.zeros(n, dtype=np.int32)
        self._failed = ctypes.c_int32(-1)
        self._cut = ctypes.c_int32(0)
        self._lengths = np.zeros(n, dtype=np.uint64)
        self._has_ref = np.zeros(n, dtype=np.uint8)
        self._ptrs = np.zeros(n, dtype=np.uint64)
        self._fixed_args = (
            n, width, height, 0,
            self._has_ref.ctypes.data,
            self._hdr.ctypes.data, mvs.ctypes.data, inter.ctypes.data,
            fused.ctypes.data, int(fused.strides[0]), mv8_stride,
            pred_scratch.ctypes.data,
            pack_cap,
            ladder.ctypes.data, int(ladder.shape[0]),
            self._counts.ctypes.data, self._flags.ctypes.data,
            ctypes.addressof(self._cut),
            ctypes.addressof(self._failed),
        )

    def parse(self, buffers, has_reference):
        """Parse all streams' frames into the fused staging rows.

        Returns (hdr int32[n,8], counts, flags, cut) — cut is the chosen
        coefficient bucket (ship row bytes up to mv_sz + ib_sz + 3*cut).
        """
        n = self._n
        assert len(buffers) == n
        if _fastcall is not None:
            _fastcall.gather_ptrs(buffers, self._ptrs.ctypes.data,
                                  self._lengths.ctypes.data)
            ptrs_addr = self._ptrs.ctypes.data
            keepalive = buffers
        else:
            keepalive = (ctypes.c_char_p * n)(*buffers)
            self._lengths[:] = [len(b) for b in buffers]
            ptrs_addr = ctypes.addressof(keepalive)
        self._has_ref[:] = has_reference
        rc = _lib.h263_sorenson_decode_batch_fused(
            ptrs_addr, self._lengths.ctypes.data, *self._fixed_args)
        del keepalive
        if rc != 0:
            exc = _ERROR_MAP.get(rc, InternalDecoderError)
            raise exc(f"stream {int(self._failed.value)}: native error {rc}")
        return self._hdr, self._counts, self._flags, int(self._cut.value)


class NeedsPythonHeader(Exception):
    """The batch contains a header outside the native PTYPE-only fast path
    (PLUSPTYPE chain, PB frame, reserved/invalid format, malformed bits).
    Nothing was committed; the caller replays through the exact Python
    header parser."""


E_NEEDS_PYTHON = 100


def _setup_std_batch_sig(lib):
    import ctypes as C

    lib.h263_standard_decode_batch.restype = C.c_int
    lib.h263_standard_decode_batch.argtypes = [
        C.c_void_p, C.c_void_p,              # buffers (ptr array), lengths
        C.c_int32, C.c_int32, C.c_int32,     # n, w, h
        C.c_int32,                           # xflags (transport)
        C.c_void_p, C.c_void_p, C.c_void_p,  # has_ref, prev_running, prev_fmt
        C.c_void_p, C.c_void_p,              # hdr_all, mvs_all
        C.c_void_p, C.c_void_p,              # mvs_slim_all, inter_all
        C.c_void_p,                          # pred_scratch
        C.c_void_p, C.c_void_p, C.c_int32,   # pack_all, packval_all, cap
        C.c_void_p, C.c_void_p,              # counts, flags
        C.c_void_p,                          # failed_stream
    ]
    lib.h263_option_masks.restype = C.c_int
    lib.h263_option_masks.argtypes = [C.c_void_p, C.c_void_p]


def native_option_masks():
    """(OPPTYPE, MPPTYPE) carry-forward masks as compiled into the native
    library — pinned against types.py by tests."""
    assert _lib is not None
    if not hasattr(_lib, "_std_sig_done"):
        _setup_std_batch_sig(_lib)
        _lib._std_sig_done = True
    opp = np.zeros(1, dtype=np.uint32)
    mpp = np.zeros(1, dtype=np.uint32)
    _lib.h263_option_masks(opp.ctypes.data, mpp.ctypes.data)
    return int(opp[0]), int(mpp[0])


class StandardBatchParser:
    """One-FFI-call batch parser for standard (non-Sorenson) H.263 streams
    with plain PTYPE headers.  Raises NeedsPythonHeader (nothing committed)
    when any stream's header needs the full Python parser."""

    __slots__ = ("_n", "_w", "_h", "_cap", "_xflags", "hdr", "_counts",
                 "_flags", "_failed", "_lengths", "_has_ref", "_ptrs",
                 "prev_running", "prev_fmt", "_fixed_args")

    def __init__(self, n: int, width: int, height: int, pack_pos: np.ndarray,
                 mvs: np.ndarray, inter: np.ndarray, pred_scratch: np.ndarray,
                 pack_val: np.ndarray = None, transport: str = "u32",
                 mvs_slim: np.ndarray = None):
        assert _lib is not None
        if not hasattr(_lib, "_std_sig_done"):
            _setup_std_batch_sig(_lib)
            _lib._std_sig_done = True
        if transport == "d24":
            assert pack_val is None
            assert pack_pos.dtype == np.uint8 and pack_pos.shape[1] % 3 == 0
        elif pack_val is not None:
            transport = "split"
            assert pack_val.shape == pack_pos.shape
            assert pack_val.dtype == np.int16
        assert pack_pos.shape[0] == n and mvs.shape[0] == n
        self._n, self._w, self._h = n, width, height
        self._cap = int(pack_pos.shape[1] // (3 if transport == "d24" else 1))
        self._xflags = F_PACK_DELTA24 if transport == "d24" else 0
        self.hdr = np.zeros((n, 10), dtype=np.int32)
        self._counts = np.zeros(n, dtype=np.int32)
        self._flags = np.zeros(n, dtype=np.int32)
        self._failed = ctypes.c_int32(-1)
        self._lengths = np.zeros(n, dtype=np.uint64)
        self._has_ref = np.zeros(n, dtype=np.uint8)
        self._ptrs = np.zeros(n, dtype=np.uint64)
        self.prev_running = np.zeros(n, dtype=np.uint32)
        self.prev_fmt = np.full(n, -1, dtype=np.int32)
        self._fixed_args = (
            self._n, self._w, self._h, self._xflags,
            self._has_ref.ctypes.data,
            self.prev_running.ctypes.data, self.prev_fmt.ctypes.data,
            self.hdr.ctypes.data, mvs.ctypes.data,
            mvs_slim.ctypes.data if mvs_slim is not None else None,
            inter.ctypes.data,
            pred_scratch.ctypes.data,
            pack_pos.ctypes.data,
            pack_val.ctypes.data if pack_val is not None else None,
            self._cap,
            self._counts.ctypes.data, self._flags.ctypes.data,
            ctypes.addressof(self._failed),
        )

    def parse(self, buffers, has_reference):
        """Parse all streams' frames (caller fills prev_running/prev_fmt).

        Returns (hdr int32[n,10], counts, flags).  hdr columns: [tr, w, h,
        ptype, header_opts, quant, cpm, psbi, fmt_bits, running_opts].
        Raises NeedsPythonHeader for fast-path misses, else the mapped
        decode error."""
        n = self._n
        assert len(buffers) == n
        if _fastcall is not None:
            _fastcall.gather_ptrs(buffers, self._ptrs.ctypes.data,
                                  self._lengths.ctypes.data)
            ptrs_addr = self._ptrs.ctypes.data
            keepalive = buffers
        else:
            keepalive = (ctypes.c_char_p * n)(*buffers)
            self._lengths[:] = [len(b) for b in buffers]
            ptrs_addr = ctypes.addressof(keepalive)
        self._has_ref[:] = has_reference
        rc = _lib.h263_standard_decode_batch(
            ptrs_addr, self._lengths.ctypes.data, *self._fixed_args)
        del keepalive
        if rc == E_NEEDS_PYTHON:
            raise NeedsPythonHeader(int(self._failed.value))
        if rc != 0:
            exc = _ERROR_MAP.get(rc, InternalDecoderError)
            raise exc(f"stream {int(self._failed.value)}: native error {rc}")
        return self.hdr, self._counts, self._flags


def _setup_device_prep_sig(lib):
    import ctypes as C

    lib.h263_device_prepare_batch.restype = C.c_int
    lib.h263_device_prepare_batch.argtypes = [
        C.c_void_p, C.c_void_p,              # buffers (ptr array), lengths
        C.c_int32, C.c_int32, C.c_int32,     # n, expected w, h
        C.c_void_p, C.c_int64,               # stage base, stride
        C.c_void_p, C.c_void_p, C.c_void_p,  # meta [5][n], hdr [n][8], rc [n]
    ]
    lib.h263_device_prepare_ragged.restype = C.c_int
    lib.h263_device_prepare_ragged.argtypes = [
        C.c_void_p, C.c_void_p,              # buffers (ptr array), lengths
        C.c_int32, C.c_int32, C.c_int32,     # n, expected w, h
        C.c_void_p, C.c_int64,               # flat stage base, cap bytes
        C.c_void_p, C.c_void_p, C.c_void_p,  # meta [6][n], hdr [n][8], rc [n]
    ]


class DevicePrepBatch:
    """Native host-side prep for the device entropy front-end: batched
    Sorenson header parse + payload copy into the staging rows of the
    single uint8 transfer leaf.  Replaces a ~8 ms/step Python loop at
    S=256 with one FFI call (~0.1 ms)."""

    __slots__ = ("_n", "_w", "_h", "_stride", "_lengths", "_ptrs",
                 "hdr", "rc")

    def __init__(self, n: int, width: int, height: int, stage_stride: int):
        assert _lib is not None
        if not hasattr(_lib, "_device_prep_sig_done"):
            _setup_device_prep_sig(_lib)
            _lib._device_prep_sig_done = True
        self._n, self._w, self._h = n, width, height
        self._stride = stage_stride
        self._lengths = np.zeros(n, dtype=np.uint64)
        self._ptrs = np.zeros(n, dtype=np.uint64)
        self.hdr = np.zeros((n, 8), dtype=np.int32)
        self.rc = np.zeros(n, dtype=np.int32)

    def prepare(self, buffers, stage: np.ndarray, meta: np.ndarray) -> int:
        """Fill `stage` (uint8 [n, stride... any trailing dims]) and `meta`
        (int32 [5, n]); returns the number of failed streams (see
        entropy.cpp h263_device_prepare_batch for per-stream rc)."""
        n = self._n
        assert len(buffers) == n
        assert stage.dtype == np.uint8 and stage.flags["C_CONTIGUOUS"]
        # Row pitch comes from the staged array itself: the caller may
        # stage into any transfer bucket up to the construction-time cap
        # (device_batch.py's bucket ladder).  Payloads longer than the
        # bucket fail per stream in C (rc E_INVALID_BITSTREAM), same as
        # the old fixed-cap overflow.
        stride = stage.strides[0]
        assert stride <= self._stride
        assert meta.shape == (5, n) and meta.dtype == np.int32
        if _fastcall is not None:
            _fastcall.gather_ptrs(buffers, self._ptrs.ctypes.data,
                                  self._lengths.ctypes.data)
            ptrs_addr = self._ptrs.ctypes.data
            keepalive = buffers
        else:
            keepalive = (ctypes.c_char_p * n)(*buffers)
            self._lengths[:] = [len(b) for b in buffers]
            ptrs_addr = ctypes.addressof(keepalive)
        failed = _lib.h263_device_prepare_batch(
            ptrs_addr, self._lengths.ctypes.data, n, self._w, self._h,
            stage.ctypes.data, stride,
            meta.ctypes.data, self.hdr.ctypes.data, self.rc.ctypes.data)
        del keepalive
        return int(failed)

    def prepare_ragged(self, buffers, stage: np.ndarray,
                       meta: np.ndarray) -> int:
        """Ragged-payload prep: pack every lane's word-aligned payload back
        to back into the FLAT uint8 `stage` (any shape; total bytes is the
        cap) and fill `meta` (int32 [6, n] — rows 0-4 as prepare(), row 5
        the lane's word offset).  Returns the failed-stream count."""
        n = self._n
        assert len(buffers) == n
        assert stage.dtype == np.uint8 and stage.flags["C_CONTIGUOUS"]
        assert meta.shape == (6, n) and meta.dtype == np.int32
        if _fastcall is not None:
            _fastcall.gather_ptrs(buffers, self._ptrs.ctypes.data,
                                  self._lengths.ctypes.data)
            ptrs_addr = self._ptrs.ctypes.data
            keepalive = buffers
        else:
            keepalive = (ctypes.c_char_p * n)(*buffers)
            self._lengths[:] = [len(b) for b in buffers]
            ptrs_addr = ctypes.addressof(keepalive)
        failed = _lib.h263_device_prepare_ragged(
            ptrs_addr, self._lengths.ctypes.data, n, self._w, self._h,
            stage.ctypes.data, stage.nbytes,
            meta.ctypes.data, self.hdr.ctypes.data, self.rc.ctypes.data)
        del keepalive
        return int(failed)
