"""WAV -> MP3 encoder: the torch analysis and search planes on the device,
exact host rate-control carries, frame serialization where the quantized
spectra are (the card's kernel, ``ops/serialize``, or the host's C call).

Behavioural reference (bit-for-bit): the reference's mp3stego/encoder/
  MP3_Encoder.py (frame loop 596-650, iteration loop 760-815, scfsi 817-892,
  reservoir 894-931/1097-1145, outer/bin-search/inner 933-996/1064-1095,
  bitstream formatting 1266-1547) and encoder.py:8-58 (driver + too_long).

The engines, all byte-identical (``MP3Encoder.encode``):

* search plane (default): the whole file's Q31 analysis + MDCT
  (``ops/encode_plane``) and the rate-control search of every granule
  (``ops/search_plane``, exact float64) run in torch on ``device``; the host
  redoes the few flagged granules with the exact oracle, then runs the
  reservoir chain and scfsi; the frames are serialized from the resident
  spectra (``_plane_serialize``).
* hide (default with ``hide_str``): the device searches every granule
  without the stego transform and under each of the eight 3-bit windows of
  message bits a granule can read; one host scan in cursor order picks each
  granule's result from its true cursor (``_encode_hide``). Exact in one
  pass, whatever the file's length.

Both plane engines also take a window of frames (``models/streaming``):
each (gr, ch) slot's step and stale addresses carry from one call to the
next (``_slot_carry``), as do the reservoir, the padding slot lag and the
stego cursor.
* host C++ (``_encode_host``): the native analysis and sequential whole-file
  search; the card's oracle, and the plane engines' stand-in under
  ``MP3STEGO_TPU_ENC_HOST=1`` (``utils/calibrate.entry_engine``: the
  override only, no cost model).
* cost grid (``MP3STEGO_TPU_SEARCH_PLANE=0``, the JAX package's own switch;
  ``_encode_grid``): the whole file's analysis on the device, then every
  granule costed at all 128 quantizer steps in one launch
  (``ops/quant_batch``, kernel K5); the reference's sequential frame loop
  then replays each granule's bisection and inner loop from the grid
  (``_outer_loop_cached``), evaluating on the host only the cells the grid
  flags and each granule's final state. Clear, hide and VBR.
* host oracle (``device_search=False``): the sequential per-frame search of
  the reference, native or NumPy.

VBR (``vbr=True``, beyond the reference, which is CBR-only) picks one global
quantizer step by bisection over the whole file's cost and gives each frame
the smallest standard rate whose budget clears that step's cost
(``_vbr_framing``); every engine then searches and serializes under those
per-frame budgets, and the stream opens with a Xing tag frame.

The stego channel injects the Huffman pair transform at table-selection time
exactly like the reference (tables.TRANSFORM_HUF == IDX_TO_TRANSFORM_HUF,
MP3_Encoder.py:419-449).
"""

import contextlib
import functools as _ft
import os
import struct
import sys
import time

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.bitstream.bits import BitWriter
from mp3stego_tpu_torch.ops import encode_plane as EP
from mp3stego_tpu_torch.ops import fixedpoint as fx
from mp3stego_tpu_torch.ops import quant as Q
from mp3stego_tpu_torch.ops import quant_batch as QB
from mp3stego_tpu_torch.ops import search_plane as SP
from mp3stego_tpu_torch.ops import serialize as SZ
from mp3stego_tpu_torch.utils import calibrate
from mp3stego_tpu_torch.utils.profiling import (StageTimer, count, progress,
                                                span, trace)
from mp3stego_tpu_torch.utils.transfer import (fetch_pieces, put_pieces,
                                               put_tree, resolve_device)
from mp3stego_tpu_torch.utils.wav import WavFile, read_wav

_LN2 = 0.69314718  # the reference's constant (encoder/util.py:13), not log(2)

@_ft.lru_cache(maxsize=1)
def _huff_code_u32():
    return np.ascontiguousarray(T.HUFF_CODE.reshape(-1).astype(np.uint32))


@_ft.lru_cache(maxsize=1)
def _huff_len_u8():
    return np.ascontiguousarray(T.HUFF_LEN.reshape(-1).astype(np.uint8))


@_ft.lru_cache(maxsize=1)
def _linbits_i32():
    return np.ascontiguousarray(T.HUFF_LINBITS.astype(np.int32))


@_ft.lru_cache(maxsize=1)
def _slen1_i32():
    return np.ascontiguousarray(T.SLEN1_TAB.astype(np.int32))


@_ft.lru_cache(maxsize=1)
def _slen2_i32():
    return np.ascontiguousarray(T.SLEN2_TAB.astype(np.int32))


@_ft.lru_cache(maxsize=None)
def _band_row_i32(band_row):
    return np.ascontiguousarray(T.BAND_ALL[band_row].astype(np.int32))


def _init_rate_tables(lib) -> bool:
    """Initialize a loaded rate-search library's table globals."""
    st, sti, i2i = T.loop_tables()
    i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
    rc = lib.rate_tables_init(
        np.ascontiguousarray(st, np.float64), i32(sti), i32(i2i),
        i32(T.HUFF_LEN), i32(T.HUFF_XLEN), i32(T.HUFF_LINBITS),
        i32(T.HUFF_LINMAX), i32(Q._QLEN0), i32(Q._QLEN1),
        i32(T.BAND_ALL), T.BAND_ALL.size,
        i32(T.SUBDV_TABLE), i32(T.TRANSFORM_HUF))
    return rc == 0


@_ft.lru_cache(maxsize=1)
def _native_rate_lib():
    """The native rate-search twin (native/src/rate_search.cpp) with its
    table globals initialized, or None when the toolchain is unavailable.
    Bit-identical to the ops/quant NumPy primitives (integer math + IEEE
    sqrt only)."""
    from mp3stego_tpu_torch import native
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "rate_bin_search"):
        return None
    return lib if _init_rate_tables(lib) else None


def _ix_home(ix: torch.Tensor):
    """A search's ``ix`` where the serializer reads it: resident on a card
    (``ops/serialize.pack_frames``), as NumPy on the host
    (``mp3_format_frames``)."""
    return ix if ix.device.type == "cuda" else ix.numpy()


def _put_rows(ix, rows: dict, stage):
    """Write host rows ``{lane: (576,) int32}`` into ``ix``: in place on
    the host; on the card, the rows and their lanes in one staged put (in
    the stage ``h2d`` of ``stage``), then one scatter."""
    if not rows:
        return
    lanes = np.fromiter(rows, np.int64, len(rows))
    block = np.stack([rows[g] for g in lanes]).astype(np.int32)
    if isinstance(ix, np.ndarray):
        ix[lanes] = block
        return
    with stage("h2d"):
        up = put_tree({"lanes": lanes, "rows": block}, ix.device)
    ix.index_copy_(0, up["lanes"], up["rows"])


def _format_frames_native(lib, ix: np.ndarray, side: np.ndarray,
                          frames: np.ndarray, cfg: np.ndarray, cache,
                          cache_bits) -> bytes:
    """``mp3_format_frames`` in ONE C call on the serializer's inputs
    (``ops/serialize``: ``ix``, ``side``, ``frames``, ``cfg``), laid out
    as the C call reads them: the whole file's frames as bytes. ``cache``
    ((1,) uint32) and ``cache_bits`` ((1,) int32) carry the 32-bit bit
    cache in place; raises on a stream past the buffer."""
    c = dict(zip(SZ.CONFIG, (int(v) for v in cfg[:len(SZ.CONFIG)])))
    nch, gpf, nf = c["nch"], c["gpf"], frames.shape[0]

    def fgc(a):
        # (nch*tg,) lane layout -> (nf, gpf, nch)
        return np.moveaxis(a.reshape(nch, nf, gpf), 0, 2)

    fld = dict(zip(SZ.FIELDS, side))
    gi = np.zeros((nf, 2, 2, 11), np.int64)
    for k, name in enumerate(SZ.FIELDS[:11]):
        gi[:, :gpf, :nch, k] = fgc(fld[name])
    ts = np.zeros((nf, 2, 2, 3), np.int32)
    for r in range(3):
        ts[:, :gpf, :nch, r] = fgc(fld[f"table_select{r}"])
    l3 = np.zeros((nf, 2, 2, 576), np.int32)
    l3[:, :nch, :gpf] = np.moveaxis(ix.reshape(nch, nf, gpf, 576), 0, 1)
    out = np.zeros(SZ.capacity(nf), np.uint8)
    i32 = np.ascontiguousarray
    written = lib.mp3_format_frames(
        cache, cache_bits, out, len(out), nf, c["version"], c["layer"],
        c["crc"], i32(frames[:, 0]), c["sr_mod3"], i32(frames[:, 1]),
        c["ext"], c["mode"], c["mode_ext"], c["copyright"], c["original"],
        c["emphasis"], c["private_bits"], nch, gpf,
        i32(frames[:, 2:].reshape(-1)), gi.reshape(-1), ts.reshape(-1),
        np.zeros(nf * 2 * 2 * 22, np.int32), _slen1_i32(), _slen2_i32(),
        l3.reshape(-1), _huff_code_u32(), _huff_len_u8(), _linbits_i32(),
        i32(cfg[len(SZ.CONFIG):]))
    if written < 0:
        raise RuntimeError("native serializer buffer overflow")
    return out[:written].tobytes()


_EMPTY_HIDE = np.zeros(1, np.uint8)
# the search flags that send a lane to the host oracle, by name
_FLAGS = (("ADDR", SP.FLAG_ADDR), ("OOB", SP.FLAG_OOB), ("ITER", SP.FLAG_ITER))
# lanes per hide window pass: 8 searches each, 32,768 lanes on the card
# at once, as many as one clear pass over a 4-minute stereo song
_HIDE_BLOCK = 4096


def _state_of(cod_info) -> np.ndarray:
    """GrInfo -> the int64[12] state layout shared with rate_search.cpp."""
    s = np.empty(12, np.int64)
    s[0] = cod_info.quantizerStepSize
    s[1] = cod_info.address1
    s[2] = cod_info.address2
    s[3] = cod_info.address3
    s[4] = cod_info.big_values
    s[5] = cod_info.count1
    s[6] = cod_info.count1table_select
    s[7] = cod_info.region0_count
    s[8] = cod_info.region1_count
    s[9:12] = cod_info.table_select
    return s


def _state_back(s: np.ndarray, cod_info):
    cod_info.quantizerStepSize = int(s[0])
    cod_info.address1 = int(s[1])
    cod_info.address2 = int(s[2])
    cod_info.address3 = int(s[3])
    cod_info.big_values = int(s[4])
    cod_info.count1 = int(s[5])
    cod_info.count1table_select = int(s[6])
    cod_info.region0_count = int(s[7])
    cod_info.region1_count = int(s[8])
    cod_info.table_select[:] = s[9:12]


_EN_TOT_KRIT = 10
_EN_DIF_KRIT = 100
_EN_SCFSI_BAND_KRIT = 10
_XM_SCFSI_BAND_KRIT = 10
_SCFSI_BAND_LONG = (0, 6, 11, 16, 21)


def _find_bitrate_index(bitrate: int, mpeg_version: int) -> int:
    for i in range(16):
        if bitrate == int(T.BIT_RATES[i][mpeg_version]):
            return i
    return -1


def _find_samplerate_index(samplerate: int) -> int:
    for i in range(9):
        if samplerate == int(T.SAMPLE_RATES[i]):
            return i
    return -1


def _find_mpeg_version(sr_idx: int) -> int:
    if sr_idx < 3:
        return 3  # MPEG-I
    if sr_idx < 6:
        return 2  # MPEG-II
    return 0      # MPEG-2.5


class MP3Encoder:
    """Encode a WavFile into MP3 bytes, optionally embedding a hidden bit string.

    :param wav_file: parsed WAV (utils.wav.read_wav).
    :param hide_str: bit string ('0'/'1' chars) to embed via Huffman-pair
        steganography; empty disables embedding.
    :param device_search: False runs the pure host oracle (no device).
    :param lsf_compliant: MPEG-2/2.5 only; see below.
    :param vbr: constant-quality VBR, ``wav_file.bitrate`` the target
        average, with a Xing tag (``_vbr_framing``); a hide raises
        ``ValueError``.
    :param device: the planes' device; None means CUDA, and a missing card
        raises (unless ``device_search`` is False).

    After ``encode``, ``timer`` holds its per-stage wall times (on a CUDA
    device each stage boundary waits for the card), ``redo_stats`` the
    lanes the host redid by flag, and ``hide_stats`` the hide's cursor scan
    record (``_encode_hide``).
    """

    def __init__(self, wav_file: WavFile, hide_str: str = "",
                 device_search: bool = True, lsf_compliant: bool = None,
                 vbr: bool = False, device=None):
        w = wav_file
        self.wav = w
        self.hide_str = hide_str
        # the stego contract is defined on the reference's CBR layout
        self.vbr = bool(vbr)
        if self.vbr and hide_str:
            raise ValueError("hide is defined on CBR streams only; "
                             "encode with vbr=False to embed a message")
        self._vbr_rate_idx = None        # (F,) header indices, _vbr_framing
        self.vbr_steps = None            # the steps its bisection costed
        # MPEG-2/2.5 only: write the ISO 13818-3 LSF side info correctly
        # (scale_fac_scale + count1table_select bits, byte-aligned frames)
        # instead of the reference's layout, which omits those 2 bits per
        # (gr, ch) and emits half-byte-misaligned frames no decoder can
        # fully read (count1 table choice is lost). Default stays reference-
        # byte-identical; opt in per call or via MP3STEGO_TPU_LSF_COMPLIANT=1.
        if lsf_compliant is None:
            lsf_compliant = os.environ.get(
                "MP3STEGO_TPU_LSF_COMPLIANT", "0") == "1"
        self.lsf_compliant = lsf_compliant
        self.hide_str_offset = 0
        # hide bits as 0/1 bytes for the native search twin and the plane
        self._hide_u8 = (np.frombuffer(hide_str.encode(), np.uint8)
                         - ord('0')).astype(np.uint8) if hide_str \
            else _EMPTY_HIDE
        self.device_search = device_search
        self.device = resolve_device(device) if device_search else None
        self.timer = None
        self.redo_stats = None
        self.hide_stats = None
        self._nat_ser = None
        # each (gr, ch) slot's step (nch, gpf) and stale addresses (nch,
        # gpf, 3) after the frames encoded so far; None at the file's start
        self._slot_carry = None
        # the cost-grid engine's grid (quant_batch.cost_all_steps), its
        # granules a channel, and the step of the search's last evaluation
        # when that evaluation ran exactly on the host (None otherwise)
        self._cost = None
        self._tg = None
        self._last_exact_step = None

        self.mode = w.mpeg_mode
        self.bitrate = w.bitrate
        self.emphasis = w.emphasis
        self.copyright = w.copyright
        self.original = w.original
        self.layer = 1          # header code for Layer III
        self.crc = 0
        self.ext = 0
        self.mode_ext = 0
        self.bits_per_slot = 8

        self.samplerate_index = _find_samplerate_index(w.samplerate)
        self.version = _find_mpeg_version(self.samplerate_index)
        self.bitrate_index = _find_bitrate_index(self.bitrate, self.version)
        self.granules_per_frame = 2 if self.version == 3 else 1
        # Band-table row for every engine (tables.BAND_ALL): the compliant
        # LSF writer uses the ISO/ecosystem rows (+9) so third-party decoders
        # map its serialized region counts back to the same sample
        # boundaries (the reference rows deviate at 16/24 kHz); the
        # reference-layout writer keeps the reference rows byte-for-byte.
        self.band_row = self.samplerate_index + (
            9 if (self.version != 3 and self.lsf_compliant) else 0)

        if self.version != 3 and self.lsf_compliant:
            # Exact rational slot arithmetic for the spec-valid LSF writer.
            # The reference's float formula loses the last ulp on exact-
            # integer slot counts (576/16000*6000 = 215.999...97), flipping
            # the padding chain so the header promises one more byte than
            # the frame carries — every decoder loses sync at frame 1. The
            # same float bug is behind the reference's documented 32k/192
            # MPEG-1 self-desync quirk, which the default layout reproduces
            # byte-for-byte.
            num = self.granules_per_frame * 576 * 1000 * self.bitrate
            den = self.bits_per_slot * w.samplerate
            self.whole_slots_per_frame = num // den
            self.frac_slots_per_frame = (num % den) / den
        else:
            avg_slots_per_frame = (
                self.granules_per_frame * 576.0 / w.samplerate) * (
                1000.0 * self.bitrate / self.bits_per_slot)
            self.whole_slots_per_frame = int(avg_slots_per_frame)
            self.frac_slots_per_frame = (avg_slots_per_frame
                                         - self.whole_slots_per_frame)
        self.slot_lag = -self.frac_slots_per_frame
        self.padding = 0

        nch = w.num_of_channels
        if self.granules_per_frame == 2:
            self.side_info_len = 8 * ((4 + 17) if nch == 1 else (4 + 32))
        else:
            self.side_info_len = 8 * ((4 + 9) if nch == 1 else (4 + 17))

        self.resv_max = 0
        self.resv_size = 0.0
        self.scfsi = np.zeros((2, 4), dtype=np.int32)
        self.private_bits = 0
        self.resv_drain = 0
        # persistent per-(gr,ch) coding state (stale-field semantics preserved)
        self.gr_info = [[Q.GrInfo() for _ in range(2)] for _ in range(2)]
        self.scale_factor_l = np.zeros((2, 2, 22), dtype=np.int32)
        self.l3_enc = np.zeros((nch, 2, 576), dtype=np.int32)
        # per-channel scfsi energy state (reference L3Loop en/en_tot/xrmaxl)
        self.en_tot = np.zeros(2, dtype=np.int32)
        self.en = np.zeros((2, 21), dtype=np.int32)
        self.xrmaxl = np.zeros(2, dtype=np.int32)

        self.bw = BitWriter(4096)
        self.out_buffer = bytearray()

    # ------------------------------------------------------------------ encode

    def print_info(self):
        """Print info about the file about to be created (MP3_Encoder.py:581-594)."""
        version_names = ["2.5", "reserved", "II", "I"]
        mode_names = ["stereo", "joint-stereo", "dual-channel", "mono"]
        demp_names = ["none", "50/15us", "", "CITT"]
        print(f"MPEG-{version_names[self.version]} layer III, {mode_names[self.mode]}"
              f" Psychoacoustic Model: Shine")
        print(f"Bitrate: {self.bitrate} kbps ", end='')
        print(f"De-emphasis: {demp_names[self.emphasis]}\t"
              f"{'Original' if self.original else ''}\t"
              f"{'(C)' if self.copyright else ''}")
        print(f"Encoding \"{self.wav.file_path}\" to "
              f"\"{self.wav.file_path[:-3]}mp3\"\n")

    def _num_frames(self) -> int:
        samples_per_pass = self.granules_per_frame * 576 * self.wav.num_of_channels
        total = self.wav.num_of_samples * self.wav.num_of_channels
        return total // samples_per_pass + (1 if total % samples_per_pass else 0)

    def _channel_streams_i16(self, num_frames: int) -> np.ndarray:
        """(nch, F*1152) raw int16 streams; the analysis plane upshifts them
        by 16 on the device. The reference's two-cursor interleaved stepping
        (WAV_Reader.py:160-164, buffer_pos starts {0:0,1:1}, +2 per read)
        reduces to stream[c, t] = buffer[c + 2t].

        Mono reads at stride 1: the reference's feeder steps its cursor by 2
        regardless of channel count (WAV_Reader.py:160-164), which on mono
        input walks past the buffer and crashes partway through the file —
        there is no reference behavior to be byte-identical to, so mono
        encodes the actual samples instead of every other one (deliberate
        superset of the reference)."""
        nch = self.wav.num_of_channels
        need = num_frames * self.granules_per_frame * 576
        out = np.zeros((nch, need), dtype=np.int16)
        for c in range(nch):
            s = (self.wav.buffer if nch == 1
                 else self.wav.buffer[c::2])[:need]
            out[c, :len(s)] = s
        return out

    def encode(self, quiet: bool = True):
        """Encode the full file (MP3_Encoder.py:596-618) with the engine the
        constructor chose (see the module docstring). ``quiet=False`` prints
        a per-stage timing report. Recorded as the span ``encode``."""
        with span("encode"):
            dev = self.device
            sync = (lambda: torch.cuda.synchronize(dev)) \
                if dev is not None and dev.type == "cuda" else None
            timer = self.timer = StageTimer(sync=sync)
            num_frames = self._num_frames()
            if num_frames == 0:
                return
            with trace():
                if not self.device_search:
                    self._encode_sequential(num_frames, timer, quiet)
                elif os.environ.get("MP3STEGO_TPU_SEARCH_PLANE", "1") == "0":
                    self._encode_grid(num_frames, timer, quiet)
                elif not (calibrate.entry_engine("single_encode") == "host"
                          and self._encode_host(num_frames, timer)):
                    if self.hide_str:
                        self._encode_hide(num_frames, timer)
                    else:
                        self._encode_plane(num_frames, timer)
            if self.vbr:
                self.out_buffer = (bytearray(self._xing_frame(num_frames))
                                   + self.out_buffer)
            if not quiet:
                timer.print_report()

    def _encode_sequential(self, num_frames: int, timer, quiet=True):
        """The host oracle: native (or torch-on-CPU) analysis, then the
        reference's sequential per-frame search and serialization."""
        with timer.stage("analysis+mdct (host)"):
            streams = self._channel_streams_i16(num_frames)
            tg = num_frames * self.granules_per_frame
            mdct_all = EP.run_analysis_native(streams, tg)
            if mdct_all is None:
                mdct_all = EP.run_analysis_device(streams, tg, "cpu").numpy()
        if self.vbr:
            # sets _vbr_rate_idx/_vbr_rates; _encode_frame reads them
            self._vbr_framing(mdct_all.reshape(-1, 576), num_frames)
        self._frame_loop(mdct_all, num_frames, timer, quiet)

    def _frame_loop(self, mdct_all: np.ndarray, num_frames: int, timer,
                    quiet=True):
        """The reference's sequential frame loop (MP3_Encoder.py:596-618)
        over host spectra (nch, Tg, 576): each frame's search, reservoir
        and serialization, then the final flush."""
        gpf = self.granules_per_frame
        with timer.stage("rate control + serialize (host)"):
            for f in progress(range(num_frames), desc="encoding",
                              enabled=not quiet):
                self._frame_idx = f
                self._encode_frame(mdct_all[:, f * gpf:(f + 1) * gpf])
                self.out_buffer += self.bw.take_frame()
            # final flush (MP3_Encoder.py:616-618)
            self.out_buffer += self.bw.take_frame()

    def _encode_grid(self, num_frames: int, timer, quiet=True):
        """The cost-grid engine: the whole file's analysis on the device
        (K3), every granule costed at all 128 steps in one launch (K5,
        ``quant_batch.cost_all_steps``, with the hide's channels when
        hiding), VBR framing on the resident spectra (exact, ``_lane_cost``),
        then one fetch of the spectra and the reference's frame loop, whose
        search replays the grid (``_outer_loop_cached``)."""
        nch = self.wav.num_of_channels
        tg = num_frames * self.granules_per_frame
        with timer.stage("analysis+mdct (device)"):
            xr = self._analysis_device(num_frames)
        with timer.stage("step-cost grid (device)"):
            self._cost = QB.cost_all_steps(xr, self.band_row,
                                           with_hide=bool(self.hide_str))
            self._tg = tg
        if self.vbr:
            # sets _vbr_rate_idx/_vbr_rates; _encode_frame reads them
            with timer.stage("framing"):
                self._vbr_framing(xr, num_frames)
        with timer.stage("d2h"):
            mdct_all = fetch_pieces([xr.reshape(nch, tg, 576)])[0]
        del xr
        self._frame_loop(mdct_all, num_frames, timer, quiet)

    # ---------------------------------------------------------- search plane

    def _analysis_device(self, num_frames: int):
        """The resident (nch * Tg, 576) spectra; lane g = ch*tg + f*gpf + gr.

        The WAV's interleaved int16 buffer crosses to the device once as the
        host holds it (staged through pinned memory, ``put_pieces``), up to
        the last sample the analysis reads (the reader pads it with as many
        zeros again), and the analysis reads channel c at c + nch * t there
        (``encode_plane.analysis_interleaved``): the spectra of
        :meth:`_channel_streams_i16`'s streams, which no card path builds."""
        nch = self.wav.num_of_channels
        tg = num_frames * self.granules_per_frame
        buf = put_pieces(np.ascontiguousarray(
            self.wav.buffer[:nch * tg * 576], np.int16), self.device)
        return EP.analysis_interleaved(buf, nch, tg).reshape(-1, 576)

    def _lane_budgets(self, mean_bits_f) -> np.ndarray:
        """(nch * Tg,) int32 per-granule bit budgets in lane order."""
        nch = self.wav.num_of_channels
        maxb_f = np.minimum(np.asarray(mean_bits_f, np.int64) // nch,
                            Q.MAX_BITS_ALLOWANCE)
        return np.tile(np.repeat(maxb_f, self.granules_per_frame),
                       nch).astype(np.int32)

    def _scfsi_host(self, xr):
        """The scfsi energy sums of resident spectra, on the host (MPEG-1
        only: the LSF side info has no scfsi)."""
        if self.version != 3:
            return None, None
        tot, en = SP.scfsi_sums(xr, self.band_row)
        return tuple(fetch_pieces([tot, en]))

    def _encode_plane(self, num_frames: int, timer, xr=None):
        """Encode on the device planes: analysis + MDCT and the rate-control
        search of every granule run in torch on ``device``; the host redoes
        flagged granules with the exact oracle, applies the reservoir chain
        and serializes. ``xr`` (nch * Tg, 576), resident, is the spectra of
        the next ``num_frames`` frames of a windowed encode; None analyses
        the whole file."""
        tg = num_frames * self.granules_per_frame
        if xr is None:
            with timer.stage("analysis+mdct (device)"):
                xr = self._analysis_device(num_frames)
        with timer.stage("framing"):
            paddings, mean_bits_f = self._framing(xr, num_frames)
        max_bits_lanes = self._lane_budgets(mean_bits_f)
        with timer.stage("rate search (device)"):
            res_d = SP.search(xr, torch.from_numpy(max_bits_lanes)
                              .to(self.device), self.band_row)
        with timer.stage("d2h"):
            res = SP.rows_to_host(res_d)
            res["ix"] = _ix_home(res_d["ix"])
            del res_d
        with timer.stage("scfsi sums (device)"):
            en_tot_raw, en_raw = self._scfsi_host(xr)
        with timer.stage("redo (host)"):
            self._plane_redo(res, xr, max_bits_lanes, tg)
        with timer.stage("assemble+serialize (host)"):
            self._plane_finish(res, en_tot_raw, en_raw, num_frames, paddings,
                               mean_bits_f, tg)

    def _encode_host(self, num_frames: int, timer) -> bool:
        """Fully-host encode engine: C++ analysis plane + C++ sequential
        whole-file rate search (reference frame order, live stego cursor,
        per-slot stale-address chains) + batched C serializer; byte-identical
        to the device planes, which it is the oracle of. Returns False when
        the native library is unavailable."""
        lib = _native_rate_lib()
        if lib is None or not hasattr(lib, "rate_search_file"):
            return False
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf

        with timer.stage("analysis+mdct (host C++)"):
            streams = self._channel_streams_i16(num_frames)
            xr = EP.run_analysis_native(streams, tg)
            if xr is None:
                return False
            xr = np.ascontiguousarray(xr.reshape(-1, 576))

        paddings, mean_bits_f = self._framing(xr, num_frames)
        max_bits_lanes = self._lane_budgets(mean_bits_f)

        with timer.stage("rate search (host C++)"):
            lanes = nch * tg
            raw = np.zeros((lanes, 12), np.int64)
            ix = np.zeros((lanes, 576), np.int32)
            en_tot = np.zeros(lanes, np.int32)
            en21 = np.zeros((lanes, 21), np.int32)
            lib.rate_search_file(
                xr, max_bits_lanes, nch, tg, gpf,
                self.band_row * 23,
                self._hide_u8, len(self.hide_str), self.hide_str_offset,
                raw, ix, en_tot, en21,
                np.zeros(2 * 2 * 12, np.int64),
                np.zeros(2 * 2 * 576, np.int32), 0)
            res = {k: np.ascontiguousarray(raw[:, c]) for c, k in enumerate(
                ("step", "bits", "bv", "c1", "cts", "r0c", "r1c",
                 "ch0", "ch1", "ch2", "xrmax0"))}
            res["ix"] = ix
        with timer.stage("assemble+serialize (host)"):
            self._plane_finish(res, en_tot if self.version == 3 else None,
                               en21 if self.version == 3 else None,
                               num_frames, paddings, mean_bits_f, tg)
        return True

    def _plane_framing(self, num_frames: int):
        """Per-frame padding + mean_bits — the data-independent preamble of
        _encode_frame (MP3_Encoder.py:630-641), run for the whole file."""
        paddings = []
        mean_bits_f = []
        for _ in range(num_frames):
            if self.frac_slots_per_frame:
                self.padding = 1 if self.slot_lag <= (
                    self.frac_slots_per_frame - 1.0) else 0
                self.slot_lag += self.padding - self.frac_slots_per_frame
            paddings.append(self.padding)
            bits_per_frame = 8 * (self.whole_slots_per_frame + self.padding)
            mean_bits_f.append(int((bits_per_frame - self.side_info_len)
                                   / self.granules_per_frame))
        return paddings, mean_bits_f

    # ------------------------------------------------------------------ VBR

    def _frame_rate_indices(self, nf: int) -> np.ndarray:
        """Per-frame header bitrate indices for the serializer: the VBR
        choice when set, else the constant CBR index."""
        if self._vbr_rate_idx is not None:
            return self._vbr_rate_idx.astype(np.int32)
        return np.full(nf, self.bitrate_index, np.int32)

    def _vbr_valid_rates(self):
        """Ascending valid Layer III rates (kbps) for this MPEG version."""
        return [int(r[self.version]) for r in T.BIT_RATES
                if int(r[self.version]) > 0]

    def _vbr_slots(self, rate_kbps: int) -> int:
        """Whole slots per frame at ``rate_kbps`` (padding-free VBR frame)."""
        return int((self.granules_per_frame * 576.0 / self.wav.samplerate)
                   * (1000.0 * rate_kbps / self.bits_per_slot))

    def _lane_cost(self, xr, step: int) -> np.ndarray:
        """Every lane's bits at quantizer step ``step`` (1 << 20 where the
        search's ixmax <= 8192 gate fails there): on ``xr``'s device for
        resident spectra (``SP.cost_step``), else with the native
        ``rate_cost_step`` twin, else ``SP.cost_step`` on the CPU."""
        if isinstance(xr, torch.Tensor):
            return SP.cost_step(xr, step, self.band_row).cpu().numpy()
        lib = _native_rate_lib()
        if lib is None:
            return SP.cost_step(torch.from_numpy(xr), step,
                                self.band_row).numpy()
        out = np.empty(xr.shape[0], np.int64)
        lib.rate_cost_step(np.ascontiguousarray(xr, np.int32), xr.shape[0],
                           step, self.band_row * 23, 1 << 20, out)
        return out

    def _vbr_framing(self, xr, num_frames: int):
        """Constant-quality VBR framing (beyond the reference, CBR-only).

        A single global quantizer step s* is chosen (by bisection over the
        monotone whole-file cost) whose slot total best matches the
        target-average rate (``wav.bitrate``); each frame then gets the
        smallest standard rate whose per-lane budget clears that step's
        cost. Frames use padding 0 (their size is their own header's).
        ``xr`` is the (nch * Tg, 576) spectra, resident or on the host
        (``_lane_cost``). Returns (paddings, mean_bits_f); records the
        per-frame header indices in ``_vbr_rate_idx`` and the steps costed
        in ``vbr_steps``."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        rates = self._vbr_valid_rates()
        slots = np.array([self._vbr_slots(r) for r in rates], np.int64)
        budgets = np.array(
            [min(int((8 * s - self.side_info_len) / gpf) // nch,
                 Q.MAX_BITS_ALLOWANCE) for s in slots], np.int64)

        cache = {}

        def plan(s: int):
            """(slot total, per-frame rate choice) at grid step s."""
            if s not in cache:
                need = self._lane_cost(xr, s - 127) \
                    .reshape(nch, num_frames, gpf).max(axis=(0, 2))
                ridx = np.minimum(np.searchsorted(budgets, need),
                                  len(rates) - 1)
                cache[s] = (int(slots[ridx].sum()), ridx)
            return cache[s]

        target = num_frames * (gpf * 576.0 / self.wav.samplerate) * (
            1000.0 * self.bitrate / self.bits_per_slot)
        # cost is non-increasing in s (coarser step -> fewer bits): bisect
        # the crossing, then take the best of the crossing's neighborhood
        lo, hi = 0, 127
        while lo < hi:
            mid = (lo + hi) // 2
            if plan(mid)[0] > target:
                lo = mid + 1
            else:
                hi = mid
        s_star = min((s for s in (lo - 1, lo, lo + 1) if 0 <= s <= 127),
                     key=lambda s: (abs(plan(s)[0] - target), s))
        self._vbr_step = s_star
        self.vbr_steps = sorted(cache)
        chosen = plan(s_star)[1]                         # (F,) rate index
        self._vbr_rate_idx = np.array(
            [_find_bitrate_index(r, self.version) for r in rates],
            np.int32)[chosen]
        self._vbr_rates = np.asarray(rates, np.int64)[chosen]
        mean_bits_f = [int((8 * int(slots[i]) - self.side_info_len) / gpf)
                       for i in chosen]
        return [0] * num_frames, mean_bits_f

    def _framing(self, xr, num_frames: int):
        """Engine-facing framing: VBR when requested, else the reference's
        CBR padding/slot-lag machinery."""
        if self.vbr:
            return self._vbr_framing(xr, num_frames)
        return self._plane_framing(num_frames)

    def _xing_frame(self, num_frames: int) -> bytes:
        """The Xing tag frame of a VBR stream (``bitstream/vbr.py`` reads
        it): fourcc + flags + frames + bytes + 100-point TOC + quality,
        inside the smallest valid silent frame that fits it."""
        si = 32 if (self.version == 3 and self.wav.num_of_channels == 2) \
            else 17 if (self.version == 3
                        or self.wav.num_of_channels == 2) else 9
        payload = 4 + 4 + 4 + 4 + 100 + 4     # fourcc/flags/frames/bytes/toc/q
        rates = self._vbr_valid_rates()
        tag_rate = next((r for r in rates
                         if self._vbr_slots(r) >= 4 + si + payload),
                        rates[-1])
        size = self._vbr_slots(tag_rate)

        bw = BitWriter()
        bw.put(0x7FF, 11)
        bw.put(self.version, 2)
        bw.put(self.layer, 2)
        bw.put(0 if self.crc else 1, 1)
        bw.put(_find_bitrate_index(tag_rate, self.version), 4)
        bw.put(self.samplerate_index % 3, 2)
        bw.put(0, 1)                          # padding
        bw.put(self.ext, 1)
        bw.put(self.mode, 2)
        bw.put(self.mode_ext, 2)
        bw.put(self.copyright, 1)
        bw.put(self.original, 1)
        bw.put(self.emphasis, 2)
        head = bytes(bw.take_frame())
        assert len(head) == 4

        # a Layer III slot is one byte: frame bytes == slots (padding-free).
        # The byte count comes from the buffer, not the slot sum: the final
        # flush drops residual cache bits (reference quirk), so the last
        # frame on disk can be up to 3 bytes short.
        frame_sizes = np.asarray(
            [self._vbr_slots(int(r)) for r in self._vbr_rates], np.int64)
        total_bytes = size + len(self.out_buffer)
        # 100-point TOC: byte offset (scaled to 0..255) of the frame at each
        # percent of stream time
        starts = size + np.concatenate([[0], np.cumsum(frame_sizes)[:-1]])
        pick = (np.arange(100, dtype=np.int64) * num_frames) // 100
        toc = np.minimum(255, (256 * starts[pick]) // total_bytes) \
            .astype(np.uint8)

        buf = bytearray(size)
        buf[0:4] = head
        pos = 4 + si
        buf[pos:pos + 4] = b"Xing"
        struct.pack_into(">I", buf, pos + 4, 0xF)           # all fields
        struct.pack_into(">I", buf, pos + 8, num_frames)
        struct.pack_into(">I", buf, pos + 12, total_bytes)
        buf[pos + 16:pos + 116] = toc.tobytes()
        struct.pack_into(">I", buf, pos + 116,
                         min(100, int(round(100 * self._vbr_step / 127))))
        return bytes(buf)

    def _slot_prev(self, searched: np.ndarray, tg: int) -> np.ndarray:
        """(nch * Tg,) the lane of the last searched granule strictly before
        each lane in its (gr, ch) slot, or -1: where a redone lane's stale
        addresses come from (MP3_Encoder.py:1010-1012)."""
        gpf = self.granules_per_frame
        shape = (self.wav.num_of_channels, tg // gpf, gpf)
        last = np.where(searched.reshape(shape),
                        np.arange(searched.size).reshape(shape), -1)
        np.maximum.accumulate(last, axis=1, out=last)
        prev = np.full(shape, -1, np.int64)
        prev[:, 1:] = last[:, :-1]
        return prev.reshape(-1)

    def _redo_lane(self, res: dict, g: int, row, max_bits: int, prev,
                   hide, flag: int) -> dict:
        """Redo lane ``g`` (spectrum ``row``) with the sequential oracle from
        the addresses of the previous searched granule of its slot
        (``prev[g]``, zeros when there is none) and patch its rows in
        ``res``. A lane flagged only ``FLAG_ADDR`` runs on the native search
        twin (``_oracle_native``); any other, whose steps may leave steptab,
        on the NumPy oracle, which raises there as the reference does.
        Returns the oracle's result."""
        from mp3stego_tpu_torch.ops import quant_np
        p = prev[g]
        if p >= 0:
            addr = tuple(int(res[k][p]) for k in ("a1", "a2", "a3"))
        elif self._slot_carry is not None:        # from an earlier window
            tg = len(res["step"]) // self.wav.num_of_channels
            addr = tuple(int(a) for a in self._slot_carry["addr"][
                g // tg, g % self.granules_per_frame])
        else:
            addr = (0, 0, 0)
        lib = _native_rate_lib()
        if lib is not None and flag == SP.FLAG_ADDR:
            r = self._oracle_native(lib, row, max_bits, addr, hide)
        else:
            r = quant_np.oracle_search(row, max_bits, addr, self.band_row,
                                       hide=hide)
        for k in ("step", "bits", "bv", "c1", "a1", "a2", "a3", "r0c", "r1c",
                  "cts"):
            res[k][g] = r[k]
        res["ch0"][g], res["ch1"][g], res["ch2"][g] = r["ch"]
        return r

    def _plane_redo(self, res: dict, xr, max_bits_lanes, tg: int,
                    hide_ctx=None, redone=None) -> int:
        """Redo the flagged lanes (``SP.FLAG_*``) with the sequential oracle,
        carrying the true cross-granule address state per (gr, ch) slot
        (``_redo_lane``), in lane order, so a redone lane's successors in its
        slot read its addresses. ``hide_ctx`` = (bits_u8, per-lane cursors)
        threads the stego transform through the oracle. Patches ``res`` in
        place, its ``ix`` rows with those of ``redone`` ({lane: row}, the
        hide scan's) in one put (``_put_rows``); returns the number of lanes
        redone here."""
        redone = {} if redone is None else redone
        flags = res["flags"]
        lanes = np.flatnonzero(flags != 0)
        self.redo_stats = {
            "lanes": int(len(lanes)),
            **{name: int(((flags & bit) != 0).sum()) for name, bit in _FLAGS}}
        if len(lanes):
            rows = xr[torch.from_numpy(lanes).to(xr.device)].cpu().numpy()
            prev = self._slot_prev(res["xrmax0"] == 0, tg)
        for i, g in enumerate(lanes):
            hide = None if hide_ctx is None else \
                (hide_ctx[0], int(hide_ctx[1][g]))
            r = self._redo_lane(res, g, rows[i], int(max_bits_lanes[g]), prev,
                                hide, int(flags[g]))
            redone[g] = r["ix"]
        _put_rows(res["ix"], redone, self._stage)
        return len(lanes)

    def _oracle_native(self, lib, row, max_bits: int, addr, hide) -> dict:
        """``quant_np.oracle_search`` on the native twin (rate_bin_search +
        rate_inner_loop of rate_search.cpp, bit-identical to ops/quant):
        the same result dict, ~40x faster. ``row`` must keep every step
        inside steptab (the native quantizer does not check)."""
        state = np.zeros(12, np.int64)
        state[1:4] = addr
        ix = np.zeros(576, np.int32)
        row = np.ascontiguousarray(row, np.int32)
        xrabs = np.abs(row)                     # int32 wrap, like the ref
        xrmax = int(max(0, xrabs.max()))
        bits_u8, cur = (_EMPTY_HIDE, 0) if hide is None else hide
        n_bits = len(bits_u8) if hide is not None else 0
        if n_bits == 0:
            bits_u8 = _EMPTY_HIDE
        args = (self.band_row * 23, np.ascontiguousarray(bits_u8, np.uint8),
                n_bits, int(cur))
        state[0] = lib.rate_bin_search(row, xrabs, xrmax, max_bits, *args,
                                       state, ix)
        bits = lib.rate_inner_loop(row, xrabs, xrmax, max_bits, *args,
                                   state, ix)
        return dict(step=int(state[0]), bits=int(bits), bv=int(state[4]),
                    c1=int(state[5]), a1=int(state[1]), a2=int(state[2]),
                    a3=int(state[3]), r0c=int(state[7]), r1c=int(state[8]),
                    ch=tuple(int(t) for t in state[9:12]),
                    cts=int(state[6]),
                    ix=np.where((row < 0) & (ix > 0), -ix, ix))

    def _plane_scfsi(self, tot_raw, en_raw, searched, nf: int, tg: int):
        """Vectorized _calc_scfsi (MP3_Encoder.py:817-892) from the device's
        int32 energy sums: the int-truncated log2 energies and the four
        band criteria, per (frame, ch). Returns (nf, ch, 4) int32."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        with np.errstate(all="ignore"):
            vals = np.log(tot_raw.astype(np.float64) * 4.768371584e-7) / _LN2
            en_tot = np.where(tot_raw != 0, vals, 0.0).astype(np.int32)
            vv = np.log(en_raw.astype(np.float64) * 4.768371584e-7) / _LN2
            en = np.where(en_raw != 0, vv, 0.0).astype(np.int32)
        et = en_tot.reshape(nch, nf, gpf)
        eb = en.reshape(nch, nf, gpf, 21)
        xm = searched.reshape(nch, nf, gpf)
        cond = (2 + xm[..., 0].astype(np.int64) + xm[..., 1].astype(np.int64)
                + (np.abs(et[..., 0].astype(np.int64) - et[..., 1])
                   < _EN_TOT_KRIT)
                + (np.abs(eb[..., 0, :].astype(np.int64)
                          - eb[..., 1, :]).sum(-1) < _EN_DIF_KRIT))
        scfsi = np.zeros((nch, nf, 4), np.int32)
        for b in range(4):
            s, e = _SCFSI_BAND_LONG[b], _SCFSI_BAND_LONG[b + 1]
            d = np.abs(eb[..., 0, s:e].astype(np.int64)
                       - eb[..., 1, s:e]).sum(-1)
            scfsi[..., b] = d < _EN_SCFSI_BAND_KRIT
        scfsi = np.where((cond == 6)[..., None], scfsi, 0)
        return scfsi.transpose(1, 0, 2)

    def _stage(self, name: str):
        """The stage ``name`` of this encode's timer, where it has one."""
        return contextlib.nullcontext() if self.timer is None \
            else self.timer.stage(name)

    def _plane_finish(self, res: dict, en_tot_raw, en_raw, nf: int, paddings,
                      mean_bits_f, tg: int):
        """Reservoir chain, stuffing, scfsi, global-gain slot chain and frame
        serialization from the plane's per-granule results. A skipped
        granule takes its slot's step before these frames from
        ``_slot_carry`` (zeros at the file's start); each slot's step and
        stale addresses after them go back into it for the next window.
        Its parts are the spans ``finish.scfsi``, ``finish.steps``,
        ``finish.reservoir`` and ``finish.serialize``."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        searched = res["xrmax0"] == 0

        # the stego cursor advances even when not hiding (MP3_Encoder.py:808)
        self.hide_str_offset += int(
            (res["ch0"][searched] > 0).sum() + (res["ch1"][searched] > 0).sum()
            + (res["ch2"][searched] > 0).sum())

        scfsi_f = None
        if self.version == 3:
            with span("finish.scfsi"):
                scfsi_f = self._plane_scfsi(en_tot_raw, en_raw, searched, nf,
                                            tg)

        # global_gain: quantizerStepSize persists per (gr, ch) slot across
        # frames, so skipped (xrmax==0) granules reuse the last searched step
        with span("finish.steps"):
            steps = res["step"].reshape(nch, nf, gpf)
            smask = searched.reshape(nch, nf, gpf)
            last = np.where(smask, np.arange(nf)[None, :, None], -1)
            np.maximum.accumulate(last, axis=1, out=last)
            seed = 0 if self._slot_carry is None else \
                self._slot_carry["step"].reshape(nch, 1, gpf)
            carried = np.where(
                last >= 0,
                np.take_along_axis(steps, np.maximum(last, 0), axis=1), seed)
            gg = carried + 210
            self._carry_slots(res, last[:, -1], carried[:, -1], nf)

        with span("finish.reservoir", frames=nf):
            p23 = self._plane_reservoir(res, nf, mean_bits_f, tg)
        with span("finish.serialize", frames=nf, card_frames=0):
            self._plane_serialize(res, p23, gg, scfsi_f, paddings, nf, tg)

    def _plane_reservoir(self, res: dict, nf: int, mean_bits_f,
                         tg: int) -> np.ndarray:
        """The reservoir chain and stuffing over ``nf`` frames; returns each
        lane's part2_3_length as serialized (float64)."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        # reservoir chain + stuffing (exact float order, MP3_Encoder.py:812,
        # 1097-1145); stuffing mutates the serialized part2_3_length
        p23 = res["bits"].astype(np.float64)
        for f in range(nf):
            mb = mean_bits_f[f]
            self.mean_bits = mb
            for ch in range(nch):
                for gr in range(gpf):
                    g = ch * tg + f * gpf + gr
                    self.resv_size += (mb / nch) - float(res["bits"][g])
            if nch == 2 and (mb & 1):
                self.resv_size += 1
            over = max(0.0, self.resv_size - self.resv_max)
            self.resv_size -= over
            stuffing = over
            over = self.resv_size % 8
            if over:
                stuffing += over
                self.resv_size -= over
            if stuffing:
                g00 = f * gpf
                if p23[g00] + stuffing < Q.MAX_BITS_ALLOWANCE:
                    p23[g00] += stuffing
                else:
                    for gr in range(gpf):
                        for ch in range(nch):
                            g = ch * tg + f * gpf + gr
                            if not stuffing:
                                break
                            extra = Q.MAX_BITS_ALLOWANCE - p23[g]
                            bits_this = min(extra, stuffing)
                            p23[g] += bits_this
                            stuffing -= bits_this
                    self.resv_drain = stuffing  # never serialized (ref quirk)
        return p23

    def _plane_serialize(self, res: dict, p23, gg, scfsi_f, paddings,
                         nf: int, tg: int):
        """Serialize ``nf`` frames into ``out_buffer``, where ``ix`` lives:
        on the card, resident (``_plane_serialize_card``); on the host, in
        one native call for the whole file when the C library is available
        (``_plane_serialize_native``), else with the per-frame python
        writers, which compliant LSF always takes."""
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        compliant = self.version != 3 and self.lsf_compliant
        if isinstance(res["ix"], torch.Tensor):
            if not compliant:
                self._plane_serialize_card(res, p23, gg, scfsi_f, paddings,
                                           nf)
                return
            with self._stage("d2h"):
                res["ix"] = fetch_pieces([res["ix"]])[0]
        from mp3stego_tpu_torch import native
        lib = native.get_lib()
        if (lib is not None and hasattr(lib, "mp3_format_frames")
                and not compliant):
            # (the C serializer writes the reference's LSF layout; compliant
            # LSF mode uses the python writers)
            self._plane_serialize_native(lib, res, p23, gg, scfsi_f, paddings,
                                         nf)
            return
        ix_l = res["ix"].reshape(nch, nf, gpf, 576)

        zeros_mdct = np.zeros((nch, gpf, 576), np.int32)
        for f in range(nf):
            self.padding = int(paddings[f])
            if self._vbr_rate_idx is not None:
                self.bitrate_index = int(self._vbr_rate_idx[f])
            if self.version == 3:
                for ch in range(nch):
                    self.scfsi[ch, :4] = scfsi_f[f, ch]
            for gr in range(gpf):
                for ch in range(nch):
                    g = ch * tg + f * gpf + gr
                    gi = self.gr_info[gr][ch]
                    gi.part2_3_length = p23[g]
                    gi.big_values = int(res["bv"][g])
                    gi.count1 = int(res["c1"][g])
                    gi.global_gain = int(gg[ch, f, gr])
                    gi.scale_fac_compress = 0
                    gi.region0_count = int(res["r0c"][g])
                    gi.region1_count = int(res["r1c"][g])
                    gi.preflag = 0
                    gi.scale_fac_scale = 0
                    gi.count1table_select = int(res["cts"][g])
                    gi.part2_length = 0
                    gi.table_select[0] = int(res["ch0"][g])
                    gi.table_select[1] = int(res["ch1"][g])
                    gi.table_select[2] = int(res["ch2"][g])
            # l3_enc always carries 2 granule slots: the serializer indexes
            # (ch*2+gr)*576 regardless of granules_per_frame (C twin layout)
            l3 = np.zeros((nch, 2, 576), np.int32)
            l3[:, :gpf] = ix_l[:, f]
            self.l3_enc = l3
            self._format_bitstream(zeros_mdct)
            self.out_buffer += self.bw.take_frame()
        self.out_buffer += self.bw.take_frame()

    def _carry_slots(self, res: dict, last_f, step, nf: int):
        """Record in ``_slot_carry`` each slot's step ``step`` (nch, gpf)
        and the addresses of its last searched granule (frame ``last_f``
        (nch, gpf), -1 where these frames searched none: the slot keeps
        its earlier addresses). The host C++ chain's results carry no
        addresses; its own chain arrays hold them."""
        nch, gpf = step.shape
        addr = np.zeros((nch, gpf, 3), np.int64) if self._slot_carry is None \
            else self._slot_carry["addr"]
        if "a1" in res:
            a = np.stack([res[k] for k in ("a1", "a2", "a3")], -1) \
                .reshape(nch, nf, gpf, 3)
            at = np.take_along_axis(
                a, np.maximum(last_f, 0)[:, None, :, None], axis=1)[:, 0]
            addr = np.where(last_f[..., None] >= 0, at, addr)
        self._slot_carry = dict(step=step.copy(), addr=addr)

    def _plane_serialize_native(self, lib, res, p23, gg, scfsi_f, paddings,
                                nf):
        """Whole-file serialization in ONE C call (``mp3_format_frames``,
        ``_format_frames_native``) from the fields the card route uploads
        (``_serialize_fields``): no Python per-frame loop remains on the
        encode path."""
        side, frames = self._serialize_fields(res, p23, gg, scfsi_f,
                                              paddings, nf)
        # residual bits at EOF are dropped, as the reference's __flush does
        # (MP3_Encoder.py:1549-1552); a chunked encode (models/streaming)
        # continues one bitstream through the instance's 32-bit cache
        if self._nat_ser:
            cache, cache_bits = self._nat_cache, self._nat_cache_bits
        else:
            cache = np.zeros(1, dtype=np.uint32)
            cache_bits = np.full(1, 32, dtype=np.int32)
        self.out_buffer += _format_frames_native(
            lib, res["ix"], side, frames, self._serialize_config(), cache,
            cache_bits)

    def _serialize_fields(self, res, p23, gg, scfsi_f, paddings,
                          nf: int) -> tuple:
        """The serializer's per-lane side fields (14, lanes) and per-frame
        ints (nf, 10) (``ops/serialize.FIELDS``, ``FRAME_INTS``): the
        values both routes serialize, in lane order."""
        nch = self.wav.num_of_channels
        side = np.zeros((len(SZ.FIELDS), len(p23)), np.int32)
        for k, v in (("part2_3_length", np.asarray(p23).astype(np.int64)),
                     ("big_values", res["bv"]),
                     ("global_gain", np.asarray(gg).reshape(-1)),
                     ("region0_count", res["r0c"]),
                     ("region1_count", res["r1c"]),
                     ("count1table_select", res["cts"]),
                     ("count1", res["c1"]), ("table_select0", res["ch0"]),
                     ("table_select1", res["ch1"]),
                     ("table_select2", res["ch2"])):
            side[SZ.FIELDS.index(k)] = v
        frames = np.zeros((nf, SZ.FRAME_INTS), np.int32)
        frames[:, 0] = self._frame_rate_indices(nf)
        frames[:, 1] = paddings
        if self.version == 3 and scfsi_f is not None:
            frames[:, 2:2 + 4 * nch] = scfsi_f[:, :nch].reshape(nf, -1)
        return side, frames

    def _serialize_config(self) -> np.ndarray:
        """The serializer's constant fields (``ops/serialize.config``)."""
        return SZ.config(
            _band_row_i32(self.band_row), version=self.version,
            layer=self.layer, crc=self.crc,
            sr_mod3=self.samplerate_index % 3, ext=self.ext, mode=self.mode,
            mode_ext=self.mode_ext, copyright=self.copyright,
            original=self.original, emphasis=self.emphasis,
            private_bits=self.private_bits, nch=self.wav.num_of_channels,
            gpf=self.granules_per_frame)

    def _plane_serialize_card(self, res, p23, gg, scfsi_f, paddings, nf):
        """The frames packed on the card from the resident ``ix``
        (``ops/serialize.pack_frames``, ``csrc/serialize.cu``): the side
        fields go up in one put (the stage ``h2d``) and only the finished
        bytes come back (``d2h``). A windowed encode's bit cache carries on
        as the native route's does (``_nat_cache``); the frames count as
        ``card_frames`` of the span ``finish.serialize``."""
        ix = res["ix"]
        side, frames = self._serialize_fields(res, p23, gg, scfsi_f,
                                              paddings, nf)
        with self._stage("h2d"):
            up = put_tree({"side": side, "frames": frames}, ix.device)
        cache, cache_bits = (int(self._nat_cache[0]),
                             int(self._nat_cache_bits[0])) \
            if self._nat_ser else (0, 32)
        data, cache, cache_bits = SZ.pack_frames(
            ix, up["side"], up["frames"], self._serialize_config(), cache,
            cache_bits, stage=self._stage)
        if self._nat_ser:
            self._nat_cache[0] = cache
            self._nat_cache_bits[0] = cache_bits
        self.out_buffer += memoryview(data)
        count("card_frames", nf)

    def _encode_hide(self, num_frames: int, timer, xr=None):
        """Hide on the device planes, exact in one pass over the file (or,
        given resident spectra ``xr``, over the next ``num_frames`` frames
        of a windowed encode, the cursor continuing from
        ``hide_str_offset``).

        The stego cursor couples the granules: a granule embeds from the
        count of nonzero table selections in every granule before it, in the
        reference's order f ▸ ch ▸ gr (MP3_Encoder.py:808-809). A granule's
        search reads at most 3 message bits, at its cursor and the two after
        it, so the device searches every granule with the transform off
        (its result past the message's end) and, block by block in cursor
        order, under each of the 8 windows of 3 bits
        (``SP.search_windows``). A host scan in cursor order then gives each
        granule the window at its true cursor. Where all 8 windows agree on
        the granule's count and none is flagged, the scan needs no cursor
        to move past it; elsewhere it reads the window at the cursor, and
        redoes on the host (``_redo_lane``) a granule whose window is
        flagged and each granule whose 3 bits run past the message's end.
        ``hide_stats`` records the lanes, window lanes, blocks, sensitive
        lanes and host redos.

        The span ``hide.setup`` holds the framing, the budgets' upload, the
        clear pass and the cursor order; the redos a scan block runs add
        their seconds and lanes to its ``hide scan (host)`` span as the
        counts ``redo_s`` and ``redo_lanes``."""
        st = timer.stage
        gpf = self.granules_per_frame
        nch = self.wav.num_of_channels
        tg = num_frames * gpf
        n = nch * tg
        bits = self._hide_u8
        n_bits = len(self.hide_str)

        if xr is None:
            with st("analysis+mdct (device)"):
                xr = self._analysis_device(num_frames)
        with span("hide.setup"):
            paddings, mean_bits_f = self._plane_framing(num_frames)
            max_bits_lanes = self._lane_budgets(mean_bits_f)
            mb = torch.from_numpy(max_bits_lanes).to(self.device)
            with st("hide clear pass (device)"):
                clear = SP.search(xr, mb, self.band_row)
            with st("d2h"):
                rows = SP.rows_to_host(clear)
            # the final rows: one (15, n) matrix, the dict's rows its views
            res_mat = np.stack([rows[k] for k in SP.ROWS])
            res = dict(zip(SP.ROWS, res_mat))
            ix_d = clear["ix"]            # the final ix; windows gather in
            del clear

            # lanes in the reference's cursor order (lane g = ch * tg +
            # f * gpf + gr)
            order = (np.arange(num_frames)[:, None, None] * gpf
                     + np.arange(nch)[None, :, None] * tg
                     + np.arange(gpf)[None, None, :]).reshape(-1)
            clear_sum = np.concatenate(
                [[0], np.cumsum(SP.region_counts(res)[order])])
            prev = self._slot_prev(res["xrmax0"] == 0, tg)
        redone = {}                       # lane -> host ix
        stats = dict(lanes=n, window_lanes=0, blocks=0, sensitive=0,
                     redone=0, edge=0)
        flagged = {name: 0 for name, _ in _FLAGS}
        redo_s = [0.0]                    # the timed host redos' seconds

        def redo(g, row, c, flag):
            r = self._redo_lane(res, g, row, int(max_bits_lanes[g]), prev,
                                (bits, c), flag)
            res["flags"][g] = 0
            redone[g] = r["ix"]
            for name, bit in _FLAGS:
                flagged[name] += bool(flag & bit)
            return len([t for t in r["ch"] if t > 0])

        def timed_redo(*args):            # while the scan's span records
            t0 = time.perf_counter()
            out = redo(*args)
            redo_s[0] += time.perf_counter() - t0
            return out

        c = self.hide_str_offset
        q = 0                             # position in cursor order
        while q < n and c < n_bits:
            if c + 3 > n_bits:            # the window runs past the end
                g = int(order[q])
                if res["xrmax0"][g] == 0:
                    row = xr[g].cpu().numpy()
                    with st("redo (host)"):
                        c += redo(g, row, c, 0)
                    stats["edge"] += 1
                q += 1
                continue
            # a block up to the clear counts' guess of the message's end
            end = int(np.searchsorted(clear_sum, clear_sum[q] + n_bits - c))
            j = min(n, max(end + 64, q + 1), q + _HIDE_BLOCK)
            lanes = order[q:j]
            lanes_d = torch.from_numpy(lanes).to(self.device)
            with st("hide window pass (device)"):
                win = SP.search_windows(xr[lanes_d], mb[lanes_d],
                                        self.band_row)
            with st("d2h"):
                w_rows = SP.rows_to_host(win)
            with st("hide scan (host)") as scan:
                s0, n0 = redo_s[0], stats["redone"]
                c, k, wsel = self._scan_block(
                    w_rows, lanes, c, res_mat,
                    redo if scan is None else timed_redo, xr, stats)
                count("redo_s", redo_s[0] - s0)
                count("redo_lanes", stats["redone"] - n0)
            with st("hide window pass (device)"):
                i = np.flatnonzero(wsel >= 0)
                ix_d[torch.from_numpy(lanes[i]).to(self.device)] = \
                    win["ix"][torch.from_numpy(wsel[i] * len(lanes) + i)
                              .to(self.device)]
            del win
            stats["window_lanes"] += len(lanes)
            stats["blocks"] += 1
            q += k
        res["ix"] = _ix_home(ix_d)
        del ix_d
        # past the message's end every lane keeps its transform-free search;
        # its redone rows and the scan's go into ix in one put
        with st("redo (host)"):
            self._plane_redo(res, xr, max_bits_lanes, tg, redone=redone)
        self.redo_stats["lanes"] += stats["redone"] + stats["edge"]
        for name, v in flagged.items():
            self.redo_stats[name] += v
        self.hide_stats = stats
        with st("scfsi sums (device)"):
            en_tot_raw, en_raw = self._scfsi_host(xr)
        with st("assemble+serialize (host)"):
            self._plane_finish(res, en_tot_raw, en_raw, num_frames, paddings,
                               mean_bits_f, tg)

    def _scan_block(self, w_rows, lanes, c: int, res_mat, redo, xr, stats):
        """Walk one block's lanes (``lanes``, in cursor order, from cursor
        ``c``) through their window results ``w_rows`` (8 * m rows,
        window-major): write each lane's ``SP.ROWS`` at its true window into
        ``res_mat`` (15, n), redoing flagged windows on the host (``redo``,
        which writes its own rows). Stops at the
        block's end or before the first lane whose 3 bits run past the
        message's end. Returns (cursor, lanes walked, (m,) window chosen per
        lane, -1 where redone)."""
        m = len(lanes)
        bits = self._hide_u8
        n_bits = len(self.hide_str)
        w_mat = np.stack([w_rows[k] for k in SP.ROWS]).reshape(-1, 8, m)
        w_rows = dict(zip(SP.ROWS, w_mat))
        cnt = SP.region_counts(w_rows)                          # (8, m)
        uniform = (cnt == cnt[0]).all(0) & (w_rows["flags"] == 0).all(0)
        cnt_blk = np.where(uniform, cnt[0], 0)
        u_sum = np.concatenate([[0], np.cumsum(cnt_blk)])
        sens = np.flatnonzero(~uniform)
        stats["sensitive"] += len(sens)
        wsel = np.full(m, -1, np.int64)
        redone = np.zeros(m, bool)
        c0, done = c, 0
        # the spectra of every lane a window flags, in one copy
        fl = np.flatnonzero((w_rows["flags"] != 0).any(0))
        spectra = dict(zip(fl, xr[torch.from_numpy(lanes[fl]).to(xr.device)]
                           .cpu().numpy())) if len(fl) else {}

        def commit(b):
            """Rows of the window at the true cursor for lanes [done, b)."""
            nonlocal done
            cur = c0 + np.concatenate([[0], np.cumsum(cnt_blk[:b])])
            i = np.arange(done, b)[~redone[done:b]]
            w = SP.window_of(bits, cur[i])
            res_mat[:, lanes[i]] = w_mat[:, w, i]
            wsel[i] = w
            done = b

        k = 0
        for s in list(sens) + [m]:
            # lanes k..s-1 move the cursor by their (window-free) counts;
            # stop at the first whose 3 bits run past the end
            lim = n_bits - 3 - c + u_sum[k]
            r = k + int(np.searchsorted(u_sum[k:s + 1], lim, side="right"))
            if r <= s:
                c += int(u_sum[r] - u_sum[k])
                k = r
                break
            c += int(u_sum[s] - u_sum[k])
            k = s
            if s == m:
                break
            w = 4 * int(bits[c]) + 2 * int(bits[c + 1]) + int(bits[c + 2])
            flag = int(w_rows["flags"][w, s])
            if flag:
                commit(s)                 # its slot's chain is final
                cnt_blk[s] = redo(int(lanes[s]), spectra[s], c, flag)
                redone[s] = True
                stats["redone"] += 1
            else:
                cnt_blk[s] = cnt[w, s]
            c += int(cnt_blk[s])
            k = s + 1
        commit(k)
        return c, k, wsel

    # ------------------------------------------------------------- frame logic

    def _encode_frame(self, mdct_frame: np.ndarray):
        if self._vbr_rate_idx is not None:
            # VBR: this frame's size comes from its own chosen rate
            f = self._frame_idx
            self.padding = 0
            self.bitrate_index = int(self._vbr_rate_idx[f])
            self.bits_per_frame = 8 * self._vbr_slots(int(self._vbr_rates[f]))
        else:
            if self.frac_slots_per_frame:
                self.padding = 1 if self.slot_lag <= (
                    self.frac_slots_per_frame - 1.0) else 0
                self.slot_lag += self.padding - self.frac_slots_per_frame
            self.bits_per_frame = 8 * (self.whole_slots_per_frame
                                       + self.padding)
        self.mean_bits = int((self.bits_per_frame - self.side_info_len)
                             / self.granules_per_frame)

        self._iteration_loop(mdct_frame)
        self._format_bitstream(mdct_frame)

    def _iteration_loop(self, mdct_frame: np.ndarray):
        """Bit allocation + rate control (MP3_Encoder.py:760-815)."""
        nch = self.wav.num_of_channels
        for ch in range(nch):
            for gr in range(self.granules_per_frame):
                xr = mdct_frame[ch, gr]
                xrabs = np.abs(xr)            # int32 wrap on INT32_MIN, like ref
                xrmax = int(max(0, xrabs.max()))
                cod_info = self.gr_info[gr][ch]
                cod_info.sfb_lmax = 21

                if self.version == 3:
                    self._calc_scfsi(ch, gr, xr, xrmax)

                max_bits = self._max_reservoir_bits()

                self.scale_factor_l[gr][ch][:] = 0
                cod_info.s_len[:] = 0
                cod_info.part2_3_length = 0
                cod_info.big_values = 0
                cod_info.count1 = 0
                cod_info.scale_fac_compress = 0
                cod_info.table_select[:] = 0
                cod_info.region0_count = 0
                cod_info.region1_count = 0
                cod_info.part2_length = 0
                cod_info.preflag = 0
                cod_info.scale_fac_scale = 0
                cod_info.count1table_select = 0

                if xrmax:
                    cod_info.part2_3_length = self._outer_loop(
                        max_bits, xr, xrabs, xrmax, gr, ch)
                    self.hide_str_offset += int(cod_info.table_select[0] > 0) \
                        + int(cod_info.table_select[1] > 0) \
                        + int(cod_info.table_select[2] > 0)

                self.resv_size += (self.mean_bits / nch) - cod_info.part2_3_length
                cod_info.global_gain = cod_info.quantizerStepSize + 210

        self._resv_frame_end()

    def _calc_scfsi(self, ch, gr, xr, xrmax):
        """Scalefactor-select-information (MP3_Encoder.py:817-892). en/en_tot are
        int32 arrays in the reference, so every energy is truncated to int."""
        terms = fx.mulsr(xr, xr) >> 10
        self.xrmaxl[gr] = xrmax

        band = T.BAND_ALL[self.band_row]
        with np.errstate(all="ignore"):
            temp = int(terms.sum(dtype=np.int32))
            if temp:
                self.en_tot[gr] = np.float64(
                    np.log(np.float64(temp * 4.768371584e-7)) / _LN2)
            else:
                self.en_tot[gr] = 0
            for sfb in range(20, -1, -1):
                t = int(terms[int(band[sfb]):int(band[sfb + 1])].sum(dtype=np.int32))
                if t:
                    self.en[gr][sfb] = np.float64(
                        np.log(np.float64(t * 4.768371584e-7)) / _LN2)
                else:
                    self.en[gr][sfb] = 0

        if gr == 1:
            condition = 2 + int(self.xrmaxl[0] != 0) + int(self.xrmaxl[1] != 0)
            if abs(int(self.en_tot[0]) - int(self.en_tot[1])) < _EN_TOT_KRIT:
                condition += 1
            tp = int(np.abs(self.en[0].astype(np.int64)
                            - self.en[1].astype(np.int64)).sum())
            if tp < _EN_DIF_KRIT:
                condition += 1

            if condition == 6:
                for scfsi_band in range(4):
                    start = _SCFSI_BAND_LONG[scfsi_band]
                    end = _SCFSI_BAND_LONG[scfsi_band + 1]
                    sum0 = int(np.abs(self.en[0][start:end].astype(np.int64)
                                      - self.en[1][start:end].astype(np.int64)).sum())
                    sum1 = 0  # xm stays all-zero in the reference
                    if sum0 < _EN_SCFSI_BAND_KRIT and sum1 < _XM_SCFSI_BAND_KRIT:
                        self.scfsi[ch][scfsi_band] = 1
                    else:
                        self.scfsi[ch][scfsi_band] = 0
            else:
                self.scfsi[ch, :] = 0

    def _max_reservoir_bits(self) -> int:
        """MP3_Encoder.py:894-931. resv_max is never raised above 0 in the
        reference, so the perceptual-entropy branch is dead code there and here."""
        mean_bits = self.mean_bits // self.wav.num_of_channels
        max_bits = min(mean_bits, Q.MAX_BITS_ALLOWANCE)
        if not self.resv_max:
            return max_bits
        return max_bits  # unreachable with resv_max == 0

    # --------------------------------------------------------------- the search

    def _eval(self, ix, cod_info):
        """calc_run_len -> count1 bits -> subdivide -> table select (with stego
        transform) -> big-values bits; the shared body of both search loops."""
        Q.calc_run_len(ix, cod_info)
        bits = Q.count1_bit_count(ix, cod_info)
        Q.subdivide(cod_info, self.band_row)
        self._big_v_tab_select(ix, cod_info)
        bits += Q.big_v_bit_count(ix, cod_info)
        return bits

    def _big_v_tab_select(self, ix, cod_info):
        """Table choice per region + stego pair transform
        (MP3_Encoder.py:1147-1264). The message-bit cursor within a granule
        advances only over regions whose chosen table is nonzero."""
        idx = self.hide_str_offset
        cod_info.table_select[0] = 0 if cod_info.address1 <= 0 else \
            self._choose(ix, 0, cod_info.address1, self.hide_str_offset)
        if cod_info.table_select[0] > 0:
            idx += 1
        cod_info.table_select[1] = 0 if cod_info.address2 <= cod_info.address1 else \
            self._choose(ix, cod_info.address1, cod_info.address2, idx)
        if cod_info.table_select[1] > 0:
            idx += 1
        cod_info.table_select[2] = 0 if (cod_info.big_values << 1) <= cod_info.address2 \
            else self._choose(ix, cod_info.address2, cod_info.big_values << 1, idx)

    def _choose(self, ix, begin, end, idx):
        choice = Q.choose_table(ix, begin, end)
        if self.hide_str != "":
            if idx < len(self.hide_str):
                bit = int(self.hide_str[idx])
                return int(T.TRANSFORM_HUF[choice, bit])
            return choice
        return choice

    def _outer_loop(self, max_bits, xr, xrabs, xrmax, gr, ch):
        """MP3_Encoder.py:933-956. Under the cost-grid engine both loops
        replay the reference's trajectory over the grid
        (``_outer_loop_cached``)."""
        cod_info = self.gr_info[gr][ch]
        if self._cost is not None:
            return self._outer_loop_cached(max_bits, xr, xrabs, xrmax, gr, ch,
                                           cod_info)
        cod_info.quantizerStepSize = self._bin_search_step_size(
            max_bits, xr, xrabs, xrmax, gr, ch, cod_info)
        cod_info.part2_length = self._part2_length(gr, ch)
        huff_bits = max_bits - cod_info.part2_length
        bits = self._inner_loop(xr, xrabs, xrmax, huff_bits, gr, ch, cod_info)
        cod_info.part2_3_length = cod_info.part2_length + bits
        return cod_info.part2_3_length

    # ------------------------------------------------- cost-grid replay

    def _gidx(self, gr, ch):
        return ch * self._tg + self._frame_idx * self.granules_per_frame + gr

    def _cached_eval(self, g, step, xr, xrabs, xrmax, gr, ch, cod_info):
        """One search evaluation from the cost grid; an exact host
        evaluation for flagged cells (``approx``, ``bv == 0``) and steps off
        the grid. Mirrors the quantize -> run-length -> count1 -> subdivide
        -> table-select -> bit-count body (MP3_Encoder.py:977-985)."""
        C = self._cost
        s = step + 127
        if not (0 <= s < C["bail"].shape[1]):
            bits = self._exact_eval(step, xr, xrabs, xrmax, gr, ch, cod_info)
            self._last_exact_step = step if bits != 100000 else None
            return bits
        if C["bail"][g, s]:
            self._last_exact_step = None
            return 100000
        if C["approx"][g, s] or C["bv"][g, s] == 0 \
                or C["ixmax"][g, s] > Q.MAX_QUANTIZE_STEP:
            bits = self._exact_eval(step, xr, xrabs, xrmax, gr, ch, cod_info)
            self._last_exact_step = step if bits != 100000 else None
            return bits
        self._last_exact_step = None

        if self.hide_str != "":
            bits = int(min(C["sum0"][g, s], C["sum1"][g, s]))
            idx = self.hide_str_offset
            for r in range(3):
                pre = int(C["choice"][g, s, r])
                if pre == 0:
                    continue
                if idx < len(self.hide_str):
                    t = int(T.TRANSFORM_HUF[pre, int(self.hide_str[idx])])
                else:
                    t = pre
                bits += QB.table_cost(C, g, s, r, t)
                idx += 1
        else:
            bits = int(C["bits_total"][g, s])
        # keep the stale-address state the reference would carry
        # (addresses survive into later big_values == 0 evaluations)
        cod_info.address1 = int(C["a1"][g, s])
        cod_info.address2 = int(C["a2"][g, s])
        cod_info.address3 = 2 * int(C["bv"][g, s])
        return bits

    def _exact_eval(self, step, xr, xrabs, xrmax, gr, ch, cod_info):
        """One exact evaluation at ``step`` into ``l3_enc`` and
        ``cod_info`` (the native twin's ``rate_exact_eval``; NumPy where the
        library is missing or the step is off steptab, which the native
        quantizer does not check); 100000 where quantize bails or ixmax
        exceeds 8192."""
        if _native_rate_lib() is not None and 0 <= step + 127 < QB.S_STEPS:
            return self._rate_native_call("rate_exact_eval", xr, xrabs,
                                          xrmax, step, gr, ch, cod_info)
        ix, ix_max = Q.quantize(xr, xrabs, xrmax, step)
        if ix_max > Q.MAX_QUANTIZE_STEP:
            return 100000
        self.l3_enc[ch][gr] = ix
        return self._eval(self.l3_enc[ch][gr], cod_info)

    def _cached_ixmax(self, g, step, xr, xrabs, xrmax):
        C = self._cost
        s = step + 127
        if not (0 <= s < C["bail"].shape[1]):
            _, ix_max = Q.quantize(xr, xrabs, xrmax, step)
            return ix_max
        if C["bail"][g, s]:
            return 16384
        if C["approx"][g, s]:
            _, ix_max = Q.quantize(xr, xrabs, xrmax, step)
            return ix_max
        return int(C["ixmax"][g, s])

    def _outer_loop_cached(self, max_bits, xr, xrabs, xrmax, gr, ch,
                           cod_info):
        """The bisection and inner loop (MP3_Encoder.py:958-996,
        1064-1095) replayed over the grid; the final state (ix, every side
        information field, the stego table selection) comes from one exact
        host evaluation, unless the search's last evaluation already ran
        exactly at that step."""
        g = self._gidx(gr, ch)

        nxt = -120
        count = 120
        while True:
            half = count // 2
            bits = self._cached_eval(g, nxt + half, xr, xrabs, xrmax, gr, ch,
                                     cod_info)
            if bits < max_bits:
                count = half
            else:
                nxt += half
                count -= half
            if count <= 1:
                break
        cod_info.quantizerStepSize = nxt

        cod_info.part2_length = self._part2_length(gr, ch)
        huff_bits = max_bits - cod_info.part2_length

        if huff_bits < 0:
            cod_info.quantizerStepSize -= 1
        while True:
            while self._cached_ixmax(g, cod_info.quantizerStepSize + 1,
                                     xr, xrabs, xrmax) > Q.MAX_QUANTIZE_STEP:
                cod_info.quantizerStepSize += 1
            cod_info.quantizerStepSize += 1
            bits = self._cached_eval(g, cod_info.quantizerStepSize, xr, xrabs,
                                     xrmax, gr, ch, cod_info)
            if bits <= huff_bits:
                break

        if self._last_exact_step == cod_info.quantizerStepSize:
            final_bits = bits
        else:
            final_bits = self._exact_eval(cod_info.quantizerStepSize, xr,
                                          xrabs, xrmax, gr, ch, cod_info)
        cod_info.part2_3_length = cod_info.part2_length + final_bits
        return cod_info.part2_3_length

    def _rate_native_call(self, fn_name, xr, xrabs, xrmax, arg, gr, ch,
                          cod_info):
        """One native rate_search.cpp call with GrInfo<->state[12] sync;
        the granule's l3_enc slice is the shared inout ix buffer."""
        lib = _native_rate_lib()
        state = _state_of(cod_info)
        r = getattr(lib, fn_name)(
            np.ascontiguousarray(xr, np.int32),
            np.ascontiguousarray(xrabs, np.int32),
            xrmax, arg, self.band_row * 23,
            self._hide_u8, len(self.hide_str), self.hide_str_offset,
            state, self.l3_enc[ch][gr])
        _state_back(state, cod_info)
        return int(r)

    def _bin_search_step_size(self, desired_rate, xr, xrabs, xrmax, gr, ch, cod_info):
        """MP3_Encoder.py:958-996."""
        if _native_rate_lib() is not None:
            return self._rate_native_call("rate_bin_search", xr, xrabs,
                                          xrmax, desired_rate, gr, ch,
                                          cod_info)
        nxt = -120
        count = 120
        while True:
            half = count // 2
            ix, ix_max = Q.quantize(xr, xrabs, xrmax, nxt + half)
            if ix_max > Q.MAX_QUANTIZE_STEP:
                bit = 100000
            else:
                self.l3_enc[ch][gr] = ix
                bit = self._eval(self.l3_enc[ch][gr], cod_info)
            if bit < desired_rate:
                count = half
            else:
                nxt += half
                count -= half
            if count <= 1:
                break
        return nxt

    def _part2_length(self, gr, ch) -> int:
        """Scalefactor bits (MP3_Encoder.py:1038-1062); always 0 with
        scale_fac_compress==0 since slen tables start at 0, kept for parity."""
        gi = self.gr_info[gr][ch]
        slen1 = int(T.SLEN1_TAB[gi.scale_fac_compress])
        slen2 = int(T.SLEN2_TAB[gi.scale_fac_compress])
        bits = 0
        if gr == 0 or self.scfsi[ch][0] == 0:
            bits += 6 * slen1
        if gr == 0 or self.scfsi[ch][1] == 0:
            bits += 5 * slen1
        if gr == 0 or self.scfsi[ch][2] == 0:
            bits += 5 * slen2
        if gr == 0 or self.scfsi[ch][3] == 0:
            bits += 5 * slen2
        return bits

    def _inner_loop(self, xr, xrabs, xrmax, max_bits, gr, ch, cod_info):
        """MP3_Encoder.py:1064-1095."""
        if _native_rate_lib() is not None:
            return self._rate_native_call("rate_inner_loop", xr, xrabs,
                                          xrmax, max_bits, gr, ch, cod_info)
        if max_bits < 0:
            cod_info.quantizerStepSize -= 1
        while True:
            while True:
                ix, ix_max = Q.quantize(xr, xrabs, xrmax,
                                        cod_info.quantizerStepSize + 1)
                if ix is not None:
                    self.l3_enc[ch][gr] = ix
                if ix_max <= Q.MAX_QUANTIZE_STEP:
                    break
                cod_info.quantizerStepSize += 1
            cod_info.quantizerStepSize += 1
            bits = self._eval(self.l3_enc[ch][gr], cod_info)
            if bits <= max_bits:
                return bits

    def _resv_frame_end(self):
        """Reservoir drain + stuffing-bit planning (MP3_Encoder.py:1097-1145)."""
        if self.wav.num_of_channels == 2 and (self.mean_bits & 1):
            self.resv_size += 1
        over_bits = max(0.0, self.resv_size - self.resv_max)
        self.resv_size -= over_bits
        stuffing_bits = over_bits

        over_bits = self.resv_size % 8
        if over_bits:
            stuffing_bits += over_bits
            self.resv_size -= over_bits

        if stuffing_bits:
            gi = self.gr_info[0][0]
            if gi.part2_3_length + stuffing_bits < Q.MAX_BITS_ALLOWANCE:
                gi.part2_3_length += stuffing_bits
            else:
                for gr in range(self.granules_per_frame):
                    for ch in range(self.wav.num_of_channels):
                        gi = self.gr_info[gr][ch]
                        if not stuffing_bits:
                            break
                        extra_bits = Q.MAX_BITS_ALLOWANCE - gi.part2_3_length
                        bits_this_gr = min(extra_bits, stuffing_bits)
                        gi.part2_3_length += bits_this_gr
                        stuffing_bits -= bits_this_gr
                self.resv_drain = stuffing_bits  # never serialized (ref quirk)

    # ----------------------------------------------------------- serialization

    def _format_bitstream(self, mdct_frame):
        """MP3_Encoder.py:1266-1360. Uses the native C serializer when the
        library is available; the python BitWriter path below is the
        fallback/oracle (identical bytes)."""
        for ch in range(self.wav.num_of_channels):
            for gr in range(self.granules_per_frame):
                neg = (mdct_frame[ch][gr] < 0) & (self.l3_enc[ch][gr] > 0)
                self.l3_enc[ch][gr][neg] *= -1

        if self._nat_ser is None:
            from mp3stego_tpu_torch import native
            lib = native.get_lib()
            use = (lib is not None and hasattr(lib, "mp3_format_frame")
                   and not (self.version != 3 and self.lsf_compliant))
            self._nat_ser = lib if use else False
            if use:
                self._nat_cache = np.zeros(1, dtype=np.uint32)
                self._nat_cache_bits = np.full(1, 32, dtype=np.int32)
                self._nat_out = np.zeros(1 << 16, dtype=np.uint8)
        if self._nat_ser:
            self._format_bitstream_native()
        else:
            self._encode_side_info()
            self._encode_main_data()

    def _format_bitstream_native(self):
        gi = np.zeros((2, 2, 11), dtype=np.int64)
        for gr in range(2):
            for ch in range(2):
                g = self.gr_info[gr][ch]
                gi[gr, ch] = (int(g.part2_3_length), int(g.big_values),
                              int(g.global_gain), int(g.scale_fac_compress),
                              int(g.region0_count), int(g.region1_count),
                              int(g.preflag), int(g.scale_fac_scale),
                              int(g.count1table_select), int(g.count1),
                              int(g.part2_length))
        ts = np.stack([[self.gr_info[gr][ch].table_select for ch in range(2)]
                       for gr in range(2)]).astype(np.int32)
        written = self._nat_ser.mp3_format_frame(
            self._nat_cache, self._nat_cache_bits, self._nat_out,
            len(self._nat_out),
            self.version, self.layer, self.crc, self.bitrate_index,
            self.samplerate_index % 3, self.padding, self.ext, self.mode,
            self.mode_ext, self.copyright, self.original, self.emphasis,
            self.private_bits, self.wav.num_of_channels,
            self.granules_per_frame,
            np.ascontiguousarray(self.scfsi), gi.reshape(-1),
            np.ascontiguousarray(ts.reshape(-1)),
            np.ascontiguousarray(self.scale_factor_l.reshape(-1)),
            _slen1_i32(), _slen2_i32(),
            np.ascontiguousarray(self.l3_enc.reshape(-1)),
            _huff_code_u32(), _huff_len_u8(), _linbits_i32(),
            _band_row_i32(self.band_row))
        if written < 0:
            raise RuntimeError("native serializer buffer overflow")
        self.out_buffer += self._nat_out[:written].tobytes()

    def _encode_side_info(self):
        bw = self.bw
        bw.put(0x7FF, 11)
        bw.put(self.version, 2)
        bw.put(self.layer, 2)
        bw.put(0 if self.crc else 1, 1)
        bw.put(self.bitrate_index, 4)
        bw.put(self.samplerate_index % 3, 2)
        bw.put(self.padding, 1)
        bw.put(self.ext, 1)
        bw.put(self.mode, 2)
        bw.put(self.mode_ext, 2)
        bw.put(self.copyright, 1)
        bw.put(self.original, 1)
        bw.put(self.emphasis, 2)

        nch = self.wav.num_of_channels
        if self.version == 3:
            bw.put(0, 9)
            bw.put(self.private_bits, 3 if nch == 2 else 5)
            for ch in range(nch):
                for band in range(4):
                    bw.put(int(self.scfsi[ch][band]), 1)
        else:
            bw.put(0, 8)
            bw.put(self.private_bits, 2 if nch == 2 else 1)

        for gr in range(self.granules_per_frame):
            for ch in range(nch):
                gi = self.gr_info[gr][ch]
                bw.put(int(gi.part2_3_length), 12)
                bw.put(int(gi.big_values), 9)
                bw.put(int(gi.global_gain), 8)
                bw.put(int(gi.scale_fac_compress), 4 if self.version == 3 else 9)
                bw.put(0, 1)  # window_switching_flag
                for region in range(3):
                    bw.put(int(gi.table_select[region]), 5)
                bw.put(int(gi.region0_count), 4)
                bw.put(int(gi.region1_count), 3)
                if self.version == 3:
                    bw.put(int(gi.preflag), 1)
                    bw.put(int(gi.scale_fac_scale), 1)
                    bw.put(int(gi.count1table_select), 1)
                elif self.lsf_compliant:
                    # ISO 13818-3 LSF: these two bits ARE in the stream; the
                    # reference omits them (MP3_Encoder.py:1335-1337 guard)
                    bw.put(int(gi.scale_fac_scale), 1)
                    bw.put(int(gi.count1table_select), 1)

    def _encode_main_data(self):
        bw = self.bw
        for gr in range(self.granules_per_frame):
            for ch in range(self.wav.num_of_channels):
                gi = self.gr_info[gr][ch]
                slen1 = int(T.SLEN1_TAB[gi.scale_fac_compress])
                slen2 = int(T.SLEN2_TAB[gi.scale_fac_compress])
                sfl = self.scale_factor_l[gr][ch]
                if gr == 0 or self.scfsi[ch][0] == 0:
                    for sfb in range(6):
                        bw.put(int(sfl[sfb]), slen1)
                if gr == 0 or self.scfsi[ch][1] == 0:
                    for sfb in range(6, 11):
                        bw.put(int(sfl[sfb]), slen1)
                if gr == 0 or self.scfsi[ch][2] == 0:
                    for sfb in range(11, 16):
                        bw.put(int(sfl[sfb]), slen2)
                if gr == 0 or self.scfsi[ch][3] == 0:
                    for sfb in range(16, 21):
                        bw.put(int(sfl[sfb]), slen2)
                self._huffman_code_bits(gr, ch)

    def _huffman_code_bits(self, gr, ch):
        """MP3_Encoder.py:1394-1446, incl. the all-ones stuffing padding."""
        bw = self.bw
        gi = self.gr_info[gr][ch]
        scale_fac = T.BAND_ALL[self.band_row]
        bits_before = bw.bits_count()

        big_values = int(gi.big_values) << 1
        idx0 = gi.region0_count + 1
        region1_start = int(scale_fac[idx0])
        region2_start = int(scale_fac[idx0 + gi.region1_count + 1])

        enc = self.l3_enc[ch][gr]
        for i in range(0, big_values, 2):
            region = (i >= region1_start) + (i >= region2_start)
            table_index = int(gi.table_select[region])
            if table_index != 0:
                self._huffman_code(table_index, int(enc[i]), int(enc[i + 1]))

        count1_table = 32 + gi.count1table_select
        count1_end = big_values + (gi.count1 << 2)
        for i in range(big_values, count1_end, 4):
            self._huffman_coder_count1(
                count1_table, int(enc[i]), int(enc[i + 1]),
                int(enc[i + 2]), int(enc[i + 3]))

        written = bw.bits_count() - bits_before
        stuff = int(gi.part2_3_length - gi.part2_length - written)
        if stuff:
            for _ in range(stuff // 32):
                bw.put(0xFFFFFFFF, 32)
            rem = stuff % 32
            if rem:
                bw.put((1 << rem) - 1, rem)

    def _huffman_code(self, table_select, x, y):
        """MP3_Encoder.py:1448-1513."""
        bw = self.bw
        sign_x = 1 if x <= 0 and x != 0 else 0
        sign_y = 1 if y <= 0 and y != 0 else 0
        x = abs(x)
        y = abs(y)
        y_len = 16  # all pair tables are stored on the 16x16 grid
        if table_select > 15:
            lin_bits = int(T.HUFF_LINBITS[table_select])
            lin_bits_x = lin_bits_y = 0
            if x > 14:
                lin_bits_x = x - 15
                x = 15
            if y > 14:
                lin_bits_y = y - 15
                y = 15
            code = int(T.HUFF_CODE[table_select, x, y])
            c_bits = int(T.HUFF_LEN[table_select, x, y])
            ext = 0
            x_bits = 0
            if x > 14:
                ext |= lin_bits_x
                x_bits += lin_bits
            if x != 0:
                ext = (ext << 1) | sign_x
                x_bits += 1
            if y > 14:
                ext = (ext << lin_bits) | lin_bits_y
                x_bits += lin_bits
            if y != 0:
                ext = (ext << 1) | sign_y
                x_bits += 1
            bw.put(code, c_bits)
            bw.put(ext, x_bits)
        else:
            code = int(T.HUFF_CODE[table_select, x, y])
            c_bits = int(T.HUFF_LEN[table_select, x, y])
            if x != 0:
                code = (code << 1) | sign_x
                c_bits += 1
            if y != 0:
                code = (code << 1) | sign_y
                c_bits += 1
            bw.put(code, c_bits)
        _ = y_len

    def _huffman_coder_count1(self, table, v, w, x, y):
        """MP3_Encoder.py:1515-1547."""
        bw = self.bw
        sv, sw, sx, sy = (1 if t < 0 else 0 for t in (v, w, x, y))
        v, w, x, y = abs(v), abs(w), abs(x), abs(y)
        p = v + (w << 1) + (x << 2) + (y << 3)
        bw.put(int(T.HUFF_CODE[table, 0, p]), int(T.HUFF_LEN[table, 0, p]))
        code = 0
        cbits = 0
        if v:
            code = sv
            cbits = 1
        if w:
            code = (code << 1) | sw
            cbits += 1
        if x:
            code = (code << 1) | sx
            cbits += 1
        if y:
            code = (code << 1) | sy
            cbits += 1
        bw.put(code, cbits)

    def write_mp3_file(self, output_file: str):
        """Write the accumulated MP3 bytes (MP3_Encoder.py:1554-1563)."""
        with open(output_file, "wb") as f:
            f.write(bytes(self.out_buffer))


class Encoder:
    """Driver wrapping MP3Encoder (reference encoder/encoder.py:8-58).

    :param file_path: the wav file path.
    :param output_file_path: the mp3 output file path.
    :param bitrate: bitrate in kbps (the target average with ``vbr``).
    :param hide_str: bit string to embed (empty = no embedding).
    :param vbr: constant-quality VBR with a Xing tag (``MP3Encoder``); a
        hide raises ``ValueError``.
    :param device: the search plane's device; None means CUDA, and a missing
        card raises.

    ``mp3_encoder`` is the wrapped MP3Encoder (its ``timer``, ``redo_stats``
    and ``hide_stats`` describe the last ``encode``).
    """

    def __init__(self, file_path: str, output_file_path: str, bitrate: int = 320,
                 hide_str: str = '', vbr: bool = None, device=None):
        self.__file_path = file_path
        self.__output_file_path = output_file_path
        if not os.path.exists(self.__file_path):
            sys.exit(f'File {self.__file_path} not found.')
        self.__wav_file = read_wav(self.__file_path, bitrate)
        self.__hide_str = hide_str
        self.mp3_encoder = MP3Encoder(self.__wav_file, hide_str=hide_str,
                                      vbr=bool(vbr), device=device)

    def encode(self, quiet: bool = True) -> bool:
        """Encode; returns True if the message was too long to embed fully
        (the reference's off-by-one contract at encoder.py:49-51 included)."""
        enc = self.mp3_encoder
        if not quiet:
            enc.print_info()
        enc.encode(quiet=quiet)
        enc.write_mp3_file(self.__output_file_path)
        too_long = enc.hide_str_offset < len(self.__hide_str) - 1
        if not quiet:
            if too_long:
                print("File too short for this message length, your message has "
                      "been trimmed.")
            print(f"MP3 file created on {self.__output_file_path}")
        return too_long
