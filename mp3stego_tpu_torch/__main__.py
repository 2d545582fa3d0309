"""Command-line interface: python -m mp3stego_tpu_torch <op> ...

The subcommands and flags of the JAX package's CLI (``mp3stego_tpu``),
routed to this package, plus ``--device``: every plane runs on the card
unless ``--device cpu`` is given, the default float64 decode (bit-exact,
the host C++ plane's bytes) as the ``--precision float32`` one.
"""

import argparse
import contextlib
import os
import sys


@contextlib.contextmanager
def _env(name: str, value: str):
    """Set an environment variable for the block, then restore it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mp3stego_tpu_torch",
        description="MP3 codec + steganography on PyTorch and CUDA")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print process information")
    p.add_argument("--precision", choices=("float64", "float32"),
                   default="float64",
                   help="decode numeric plane: float64 = bit-exact parity, "
                        "float32 = <=1 LSB int16 deviation on under 1e-3 of "
                        "samples (both on --device)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the torch planes run (default: the card)")
    sub = p.add_subparsers(dest="op", required=True)

    d = sub.add_parser("decode", help="MP3 -> WAV")
    d.add_argument("input"), d.add_argument("output")
    d.add_argument("--stream-chunk-frames", type=int, default=0,
                   metavar="N",
                   help="decode in O(chunk) memory windows of N frames "
                        "(bounded-RSS long-file mode, float64 on --device; "
                        "0 = whole-file)")

    e = sub.add_parser("encode", help="WAV -> MP3")
    e.add_argument("input"), e.add_argument("output")
    e.add_argument("--bitrate", type=int, default=320)
    e.add_argument("--lsf-compliant", action="store_true",
                   help="MPEG-2/2.5 only: write spec-valid ISO 13818-3 side "
                        "info instead of the reference-identical layout "
                        "(which is misaligned and undecodable)")
    e.add_argument("--vbr", action="store_true",
                   help="constant-quality VBR with --bitrate as the target "
                        "average (Xing tag written; beyond the reference)")
    e.add_argument("--stream-chunk-frames", type=int, default=0,
                   help="encode in bounded-memory windows of N frames "
                        "(byte-identical to the whole-file encode; CBR "
                        "only, the planes on --device)")

    h = sub.add_parser("hide", help="hide a message in an MP3")
    h.add_argument("input"), h.add_argument("output"), h.add_argument("message")
    h.add_argument("--keep-id3", action="store_true",
                   help="carry the input's ID3v2 tag to the output "
                        "(the reference re-encode drops it)")

    r = sub.add_parser("reveal", help="reveal a hidden message")
    r.add_argument("input"), r.add_argument("txt")

    cap = sub.add_parser("capacity",
                         help="max hideable message length for an MP3")
    cap.add_argument("input")

    c = sub.add_parser("clear", help="strip hidden data (re-encode)")
    c.add_argument("input"), c.add_argument("output")
    c.add_argument("--keep-id3", action="store_true",
                   help="carry the input's ID3v2 tag to the output")

    b = sub.add_parser("decode-batch",
                       help="decode many MP3s, a chunk of files per pass")
    b.add_argument("inputs", nargs="+")
    b.add_argument("--outdir", default=".")
    b.add_argument("--resume", action="store_true",
                   help="skip inputs whose output WAV already exists")

    be = sub.add_parser("encode-batch",
                        help="encode many WAVs, one search per group")
    be.add_argument("inputs", nargs="+")
    be.add_argument("--outdir", default=".")
    be.add_argument("--bitrate", type=int, default=320)
    be.add_argument("--resume", action="store_true",
                    help="skip inputs whose output MP3 already exists")
    return p


def _out_path(outdir: str, path: str, ext: str) -> str:
    return os.path.join(outdir,
                        os.path.splitext(os.path.basename(path))[0] + ext)


def _mp3_rate(path: str) -> int:
    """The samplerate of an MP3 file's first frame (44,100 without one):
    the rate of its WAV."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.bitstream.id3 import parse_id3
    with open(path, "rb") as f:
        data = f.read()
    id3 = parse_id3(data)
    off = id3.offset if id3.is_valid else 0
    if len(data) < off + 4:
        return 44100
    return dh.parse_header(*data[off:off + 4]).sampling_rate or 44100


def _decode_batch(args) -> int:
    from mp3stego_tpu_torch.parallel import decode_files_batched
    from mp3stego_tpu_torch.utils.wav import write_wav

    inputs = [p for p in args.inputs if not (
        args.resume and os.path.exists(_out_path(args.outdir, p, ".wav")))]
    skipped = len(args.inputs) - len(inputs)
    if skipped:
        print(f"resume: skipping {skipped} already-decoded file(s)")
    pcms = decode_files_batched(inputs, errors="isolate", out="int16",
                                device=args.device) if inputs else []
    rc = 0
    for path, pcm in zip(inputs, pcms):
        if isinstance(pcm, Exception):
            print(f"{path}: FAILED ({pcm})")
            rc = 1
            continue
        out = _out_path(args.outdir, path, ".wav")
        write_wav(out, _mp3_rate(path), pcm)   # already int16 (on the card)
        print(f"{path} -> {out}")
    return rc


def _encode_batch(args) -> int:
    from mp3stego_tpu_torch.parallel import encode_files_batched

    jobs = [(p, _out_path(args.outdir, p, ".mp3")) for p in args.inputs
            if not (args.resume
                    and os.path.exists(_out_path(args.outdir, p, ".mp3")))]
    skipped = len(args.inputs) - len(jobs)
    if skipped:
        print(f"resume: skipping {skipped} already-encoded file(s)")
    outs = encode_files_batched(jobs, bitrate=args.bitrate, errors="isolate",
                                device=args.device) if jobs else []
    rc = 0
    for (src, _), res in zip(jobs, outs):
        if isinstance(res, BaseException):
            print(f"{src}: FAILED ({res})")
            rc = 1
        else:
            print(f"{src} -> {res}")
    return rc


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    if args.op == "decode-batch":
        return _decode_batch(args)
    if args.op == "encode-batch":
        return _encode_batch(args)

    from mp3stego_tpu_torch import Steganography
    s = Steganography(quiet=not args.verbose, precision=args.precision,
                      device=args.device)
    if args.op == "decode":
        if args.stream_chunk_frames > 0:
            from mp3stego_tpu_torch.models.streaming import \
                decode_file_streaming
            info = decode_file_streaming(
                args.input, args.output,
                chunk_frames=args.stream_chunk_frames, device=args.device)
            print(f"decoded at {info['bitrate']} kbps "
                  f"({info['num_frames']} frames, streaming) "
                  f"-> {args.output}")
        else:
            bitrate = s.decode_mp3_to_wav(args.input, args.output)
            print(f"decoded at {bitrate} kbps -> {args.output}")
    elif args.op == "encode":
        if args.stream_chunk_frames > 0 and args.vbr:
            p.error("--stream-chunk-frames is CBR-only (VBR's rate "
                    "choice needs the whole file)")
        lsf = "1" if args.lsf_compliant else os.environ.get(
            "MP3STEGO_TPU_LSF_COMPLIANT", "0")
        with _env("MP3STEGO_TPU_LSF_COMPLIANT", lsf):
            if args.stream_chunk_frames > 0:
                from mp3stego_tpu_torch.models.streaming import \
                    encode_file_streaming
                encode_file_streaming(args.input, args.output, args.bitrate,
                                      chunk_frames=args.stream_chunk_frames,
                                      device=args.device)
            else:
                s.encode_wav_to_mp3(args.input, args.output, args.bitrate,
                                    vbr=args.vbr)
        print(f"encoded at {args.bitrate} kbps"
              f"{' average (VBR)' if args.vbr else ''} -> {args.output}")
    elif args.op == "hide":
        s.keep_id3 = s.keep_id3 or args.keep_id3
        too_long = s.hide_message(args.input, args.output, args.message)
        print("warning: message truncated (file too short)" if too_long
              else f"hidden -> {args.output}")
        return 1 if too_long else 0
    elif args.op == "capacity":
        print(f"{s.message_capacity(args.input)} chars")
    elif args.op == "reveal":
        s.reveal_massage(args.input, args.txt)
        print(f"revealed -> {args.txt}")
    elif args.op == "clear":
        s.keep_id3 = s.keep_id3 or args.keep_id3
        s.clear_file(args.input, args.output)
        print(f"cleared -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
