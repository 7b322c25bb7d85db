"""Command-line entry: asset scan → batched decode → engine REPL, on torch.

The reference's `main()` (blast/src/main.rs:13-131) scans `blast/assets/`,
decodes each file, picks a consensus config, and enters the real-time
loop.  `python -m audio_decoder_tpu_torch.cli repl --assets DIR` is the
same pipeline on a torch device: one batched decode for the whole folder
(the hand-written CUDA kernels on the card), consensus as a reduction,
optional resample-to-consensus (the reference skips conversion), then
the block renderer against the native sink.

``--platform {cuda,cpu}`` picks the torch device (default ``cuda``, which
raises without a card); ``--device`` names the ALSA device.

Subcommands:
  repl      — interactive engine (reads command lines from stdin)
  decode    — decode a folder, print per-file results
  render    — offline-render a command script to a WAV file
  export    — decode a folder and re-encode every file
  transcode — decode one file and re-encode it
  inspect   — byte/sync navigator over an MPEG file
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


def _build_engine(asset_dir: str, resample: bool, realtime: bool,
                  device: str, platform: str = "cuda"):
    from .codecs.registry import decode_dir, resolve_device
    from .dsp.consensus import consensus_for
    from .dsp.resample import resample_to_consensus
    from .engine import state as ES
    from .runtime.loop import EngineLoop
    from .runtime.native import Sink

    dev = resolve_device(platform)
    batch, names = decode_dir(asset_dir, device=dev)
    rate, channels = consensus_for(batch, device=dev)
    if resample:
        batch = resample_to_consensus(batch, rate, device=dev)
    err = batch.err.cpu().numpy()
    kept = [n for n, i in names.items() if err[i] == 0]
    print(f"loaded {len(kept)} tracks @ {rate} Hz, {channels} ch: "
          f"{', '.join(sorted(kept))}")
    for n, i in names.items():
        if err[i] != 0:
            print(f"  skipped {n!r} (decode error {int(err[i])})")

    sel = torch.as_tensor([names[n] for n in kept], dtype=torch.int64,
                          device=dev)
    kept_batch = dataclasses.replace(
        batch,
        data=batch.data[sel], sample_rate=batch.sample_rate[sel],
        num_channels=batch.num_channels[sel],
        bits_per_sample=batch.bits_per_sample[sel],
        valid_frames=batch.valid_frames[sel], err=batch.err[sel],
        names=tuple(kept), formats=(),
    )
    tracks, lens, chs = ES.tracks_from_batch(kept_batch, channels)
    st = ES.empty_state(tracks, lens, chs, out_channels=channels,
                        channels=channels, device=dev)
    reg = ES.HostRegistry(kept)
    sink = Sink(device, rate, channels, realtime=realtime)
    return EngineLoop(st, reg, rate, channels, sink=sink), rate, channels


def cmd_repl(args) -> int:
    loop, rate, ch = _build_engine(
        args.assets, args.resample, realtime=not args.offline,
        device=args.device, platform=args.platform)
    kind = "alsa" if loop.sink.is_hardware else "null"
    print(f"sink: {kind} ({rate} Hz x {ch}); commands: load/start/pause/"
          f"resume/stop/unload/velocity/group/tc/seq/trem/env/quit")
    from .runtime.loop import repl

    repl(loop)
    return 0


def cmd_decode(args) -> int:
    import time

    from .codecs.registry import decode_dir
    from .dsp.consensus import consensus_for
    from .utils.trace import TRACE

    t0 = time.perf_counter()
    batch, names = decode_dir(args.assets, device=args.platform)
    rate, ch = consensus_for(batch, device=args.platform)
    # per-file decode latency: decode completion (the err fetch waits for
    # the batched decode) plus each file's OWN host fetch, timed
    # individually — so the metric is independent of fetch order and file
    # count, not a cumulative sum
    batch.err.cpu()
    t_compute = time.perf_counter() - t0
    lat = {}
    for name in sorted(names):
        t1 = time.perf_counter()
        f = batch.file(names[name])  # this file's host copy only
        lat[name] = t_compute + (time.perf_counter() - t1)
        status = "ok" if f.err == 0 else f"err={f.err}"
        print(f"{name}: {status} {f.format} {f.sample_rate} Hz "
              f"{f.num_channels} ch {f.pcm.shape[0]} frames")
    print(f"consensus: {int(rate)} Hz, {int(ch)} ch")
    if getattr(args, "stats", False):
        if lat:
            vals = np.asarray(sorted(lat.values()))
            p50 = float(np.percentile(vals, 50))
            p95 = float(np.percentile(vals, 95))
            print(f"per-file decode latency: p50 {p50*1e3:.1f} ms, "
                  f"p95 {p95*1e3:.1f} ms ({len(vals)} files)")
        print("-- stage stats (items = decoded audio-seconds) --")
        print(TRACE.report())
    return 0


def cmd_render(args) -> int:
    """Offline-render a command script against an asset folder → WAV.

    Each script line is either an engine command or ``@<seconds>`` to
    advance time; rendering runs the live loop (blocks of PERIOD frames,
    speculation included), just without pacing.  The rendered int16
    frames are left on ``args.pcm`` for callers of this function."""
    loop, rate, ch = _build_engine(
        args.assets, args.resample, realtime=False, device="default",
        platform=args.platform)
    loop.sink.capture = []
    from .runtime.loop import PERIOD

    with open(args.script) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for line in lines:
        if line.startswith("@"):
            blocks = max(int(float(line[1:]) * rate) // PERIOD, 1)
            loop.run_blocks(blocks)
        else:
            if not loop.submit(line) and loop.errors:
                print(f"error: {loop.errors[-1]}", file=sys.stderr)
    if args.seconds:
        loop.run_blocks(max(int(args.seconds * rate) // PERIOD, 1))
    pcm = np.concatenate(loop.sink.capture) if loop.sink.capture else (
        np.zeros((0, ch), np.int16))
    from .io.encode import write_audio

    write_audio(args.out, pcm.astype(np.float32) / 32768.0, rate, bits=16,
                device=args.platform)
    args.pcm = pcm
    print(f"rendered {pcm.shape[0] / rate:.2f}s ({pcm.shape[0]} frames) "
          f"→ {args.out}")
    return 0


def cmd_export(args) -> int:
    """Batch decode an asset folder and re-encode every file into one
    container — ``decode_dir`` joined to its inverse ``export_batch``."""
    from .codecs.registry import decode_dir
    from .io.encode import export_batch

    batch, names = decode_dir(args.assets, device=args.platform)
    kw = {"bits": args.bits, "device": args.platform}
    if args.dither is not None:
        kw["dither"] = args.dither
    written = export_batch(args.out, batch, names,
                           container=args.container, **kw)
    skipped = sorted(set(names) - set(written))
    for name in sorted(written):
        print(f"{name} → {written[name]}")
    for name in skipped:
        print(f"{name}: skipped (decode error "
              f"{int(batch.err[names[name]])})")
    print(f"{len(written)} written, {len(skipped)} skipped → {args.out}")
    return 0 if written or not names else 1


def cmd_transcode(args) -> int:
    """Decode ANY supported input (wav/aiff/aifc/mp3/au/caf/flac/...)
    on the torch device and re-encode to the container named by the
    output extension (.wav/.aif/.aiff/.au/.snd/.caf/.flac) — the decode
    surface and the export surface joined end-to-end."""
    from .codecs.registry import decode_paths
    from .dsp.resample import resample_batch
    from .io.encode import FLOAT_CONTAINERS, write_audio

    ext = args.out.rsplit(".", 1)[-1].lower() if "." in args.out else ""
    if args.float_:
        if ext not in FLOAT_CONTAINERS:
            print(f"error: container {ext!r} has no float form",
                  file=sys.stderr)
            return 1
        if args.bits not in (16, 32):  # 16 = the flag's default
            print("error: --float output is 32-bit", file=sys.stderr)
            return 1
        args.bits = 32  # float forms are IEEE f32 in every container
    batch = decode_paths([args.input], device=args.platform)
    f = batch.file(0)
    if f.err:
        print(f"error: decode failed (err={f.err})", file=sys.stderr)
        return 1
    pcm, rate = f.pcm, int(f.sample_rate)
    if args.rate and args.rate != rate:
        pcm = resample_batch(pcm[None], rate, args.rate,
                             device=args.platform)[0].cpu().numpy()
        rate = args.rate
    kw = {"bits": args.bits, "device": args.platform}
    if args.float_:
        kw["float_"] = True  # container validated float-capable above
    write_audio(args.out, pcm, rate, **kw)
    print(f"{args.input}: {f.format} {f.sample_rate} Hz "
          f"{f.num_channels} ch → {args.out} ({rate} Hz, "
          f"{'f32' if args.float_ else args.bits})")
    return 0


def cmd_inspect(args) -> int:
    """Interactive byte/sync navigator (≙ the reference's `skiparound`
    debugging aid, mpeg.rs:305-364): n/b hunt sync words, f steps a whole
    frame via the parsed header, +N/-N move bytes, q quits."""
    from .codecs.mpeg.frontend import crc_check, lame_gapless, parse_header

    with open(args.file, "rb") as fh:
        blob = fh.read()
    gl = lame_gapless(blob)
    if gl:
        nf = f" frames={gl['frames']}" if gl["frames"] is not None else ""
        print(f"LAME tag: delay={gl['delay']} padding={gl['padding']}"
              f"{nf} (gapless trim available)")
    cur = 0

    def show():
        lo = max(cur - 8, 0)
        hi = min(cur + 24, len(blob))
        hexes = " ".join(
            f"[{blob[k]:02x}]" if k == cur else f"{blob[k]:02x}"
            for k in range(lo, hi)
        )
        line = f"@{cur}: {hexes}"
        h = None
        if cur + 4 <= len(blob) and blob[cur] == 0xFF and (blob[cur + 1] & 0xE0) == 0xE0:
            h = parse_header(int.from_bytes(blob[cur : cur + 4], "big"))
        if h:
            ok = crc_check(blob, cur, h)
            crc = "" if ok is None else (" crc:ok" if ok else " crc:BAD")
            line += (f"  <sync: v{h['version']} L{4 - h['layer']} "
                     f"{h['bitrate'] // 1000}kbps {h['sr']}Hz "
                     f"len={h['frame_len']}{crc}>")
        print(line)

    def find_sync(start: int, step: int) -> int:
        k = start
        while 0 <= k < len(blob) - 1:
            if blob[k] == 0xFF and (blob[k + 1] & 0xE0) == 0xE0:
                return k
            k += step
        return cur

    show()
    for raw in sys.stdin:
        cmd = raw.strip()
        if not cmd:
            continue
        if cmd in ("q", "quit"):
            break
        if cmd == "n":
            cur = find_sync(cur + 1, 1)
        elif cmd == "b":
            cur = find_sync(cur - 1, -1)
        elif cmd == "f":
            h = None
            if cur + 4 <= len(blob):
                h = parse_header(int.from_bytes(blob[cur : cur + 4], "big"))
            cur = min(cur + (h["frame_len"] if h else 1), len(blob) - 1)
        elif cmd == "f-":
            cur = find_sync(cur - 1, -1)
        elif cmd and (cmd[0] in "+-" and cmd[1:].isdigit()):
            cur = min(max(cur + int(cmd), 0), len(blob) - 1)
        else:
            print("commands: n b f f- +N -N q")
            continue
        show()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return args.fn(args)


def parse_args(argv=None) -> argparse.Namespace:
    """The command line as a namespace; ``--platform`` stands before the
    subcommand."""
    p = argparse.ArgumentParser(prog="audio_decoder_tpu_torch")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="torch device for decode, rendering and encoding "
                   "(default cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser(
        "repl", help="interactive engine REPL (on the card the live loop "
        "still runs below real time, so a real sink underruns: ROADMAP "
        "queue 2)")
    pr.add_argument("--assets", required=True)
    pr.add_argument("--device", default="default", help="ALSA device name")
    pr.add_argument("--resample", action="store_true",
                    help="resample tracks to the consensus rate")
    pr.add_argument("--offline", action="store_true",
                    help="no pacing/audio hardware (test mode)")
    pr.set_defaults(fn=cmd_repl)

    pd = sub.add_parser("decode", help="decode a folder and report")
    pd.add_argument("--assets", required=True)
    pd.add_argument("--stats", action="store_true",
                    help="print per-stage timers and audio-sec/sec rates")
    pd.set_defaults(fn=cmd_decode)

    pi = sub.add_parser("inspect", help="byte/sync navigator (≙ skiparound)")
    pi.add_argument("file")
    pi.set_defaults(fn=cmd_inspect)

    pv = sub.add_parser("render", help="offline-render a command script to WAV")
    pv.add_argument("--assets", required=True)
    pv.add_argument("--script", required=True,
                    help="engine commands; '@<sec>' lines advance time")
    pv.add_argument("--seconds", type=float, default=0.0,
                    help="extra tail to render after the script")
    pv.add_argument("--out", required=True)
    pv.add_argument("--resample", action="store_true")
    pv.set_defaults(fn=cmd_render)

    pe = sub.add_parser(
        "export", help="decode a folder, re-encode every file (decode_dir"
        " → export_batch)")
    pe.add_argument("--assets", required=True)
    pe.add_argument("--out", required=True, help="output directory")
    pe.add_argument("--container", default="wav",
                    help="wav/aif/aiff/au/snd/caf/flac")
    pe.add_argument("--bits", type=int, default=16)
    pe.add_argument("--dither", type=int, default=None,
                    help="TPDF dither seed (float→int mastering)")
    pe.set_defaults(fn=cmd_export)

    pt = sub.add_parser(
        "transcode", help="decode one file, re-encode to wav/aiff/au/caf/flac")
    pt.add_argument("input")
    pt.add_argument("out", help="output path; extension picks the container")
    pt.add_argument("--bits", type=int, default=16,
                    help="output bit depth (8/16/24/32)")
    pt.add_argument("--float", dest="float_", action="store_true",
                    help="32-bit IEEE float output (wav/au)")
    pt.add_argument("--rate", type=int, default=0,
                    help="resample to this rate (polyphase)")
    pt.set_defaults(fn=cmd_transcode)

    return p.parse_args(argv)


if __name__ == "__main__":
    # Hard-exit instead of sys.exit: interpreter finalization races the
    # daemon render thread when it is still inside a torch op (the repl's
    # bounded join can time out under host load), and tearing the
    # runtime's thread pools down mid-op can abort the process.  Nothing
    # here needs finalizers: the raw terminal is restored inside repl(),
    # sink handles are kernel-reclaimed, and stdio is flushed explicitly.
    # Library callers use main() directly and are unaffected.
    _rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(_rc)
