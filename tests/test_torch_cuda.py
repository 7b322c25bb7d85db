"""PyTorch port on the GPU: each CUDA kernel against its plain torch twin.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without a card.  The module imports only torch, numpy and the port (the
GPU machine has no JAX), and its MP3 inputs are the committed fixtures
under tests/data/torch_port/.  On the GPU machine run it without the
suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``window_case`` also serves the CPU tests of the window-add twins
(tests/test_torch_window_add.py), so both hold the same cases; so do
``window1_case`` (K3's own edges), which also serves
tools/rehearse_cuda.py, as ``window2_cases`` (K4's own edges),
``spmd_case`` (K5's), ``rice_case`` (the rice scan's; with
``rice_plain`` it serves tests/test_torch_rice_scan.py too) and
``predict_case`` (the predictor's; with ``decode_view`` it serves
tests/test_torch_flac_predict.py too) do;
``spmd_shards`` also builds the CPU tests' K5 cases
(tests/test_torch_parallel.py).  The FLAC encoder's bar
(``check_pass_a``, ``check_pass_b``) and ``flac_passes`` serve
tests/test_torch_flac_encode.py and chip_smoke.py's export phase too.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch import decode_paths
from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
from audio_decoder_tpu_torch.codecs.mpeg import dsp
from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD
from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
from audio_decoder_tpu_torch.codecs.mpeg import huffman_tables as HT
from audio_decoder_tpu_torch.codecs.flac import decoder as FD
from audio_decoder_tpu_torch.codecs.flac import device as FV
from audio_decoder_tpu_torch.codecs.flac import frontend as FF
from audio_decoder_tpu_torch.codecs.mpeg import native
from audio_decoder_tpu_torch.ops import flac_predict as PP
from audio_decoder_tpu_torch.ops import rice_scan as RS
from audio_decoder_tpu_torch.ops import synth_kernel as SK
from audio_decoder_tpu_torch.ops import window_add as PW

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
FIXTURES = [os.path.join(DATA, f) for f in ("stereo_44k1_128k_js.mp3",
                                            "mono_22k05_lsf.mp3")]
FLAC_FIXTURES = [os.path.join(DATA, f) for f in ("music_44k1_s16.flac",
                                                 "mono_48k_s24.flac")]

#: (seed, L, W, n_live) of the int32 window-add cases
WINDOW_CASES = [
    (0, 64, 8, 50),        # tiny widths (fixed-width warmup shape)
    (1, 256, 96, 200),     # W not a multiple of 512
    (2, 512, 512, 512),    # rice shape, no padding lanes
    (3, 300, 520, 211),    # W just past one TPU sublane row
    (4, 40, 1536, 17),     # multi-row windows
]
#: the TPU kernel's output tile (ops/window_add.py TILE_R * 512 there)
TPU_TILE = 256 * 512


def window_case(rng, L, W, n_live, tile_elems=512, dtype=np.int32):
    """Random windows with the FLAC contract: live windows tile [0, X)
    contiguously in lane order, updates past each live count are zero, and
    the padding lanes at the tail carry start 0 and zero updates."""
    counts = rng.integers(0, W + 1, size=n_live)
    starts = np.zeros(L, np.int32)
    at = 0
    for i in range(n_live):
        starts[i] = at
        at += int(counts[i])
    n_out = at + W + rng.integers(0, 3 * tile_elems)
    if dtype == np.int32:
        upd = rng.integers(-10**6, 10**6, size=(L, W)).astype(dtype)
    else:
        upd = rng.standard_normal((L, W)).astype(dtype)
    live = np.arange(W)[None, :] < counts[:, None]
    upd[:n_live] = np.where(live, upd[:n_live], 0)
    upd[n_live:] = 0
    return starts, upd, int(n_out)


#: ids of ``window1_case``: K3's own edges
WINDOW1_CASES = ("frames-f32", "frames-i32", "wide-unaligned-f32",
                 "wide-unaligned-i32", "pile-up-f32", "pile-up-i32",
                 "repointed-nonzero", "narrow-pile-up", "odd-width",
                 "truncated-f32", "truncated-i32", "no-lanes", "n-out-0",
                 "two-chunk-lanes", "many-lanes")


def window1_case(cid: str):
    """(starts, upd, n_out) of K3's edge ``cid``, from a fixed numpy seed.
    Rows 2-3 output tiles of 4096 wide (8192 and 9000), at starts that are
    multiples of 8192 like FLAC's stereo frames or at random starts (most
    not multiples of 4); a pile-up of 320 padding rows on one start (a tile
    of 321 rows); a re-pointed live lane and a padding lane with nonzero
    updates; narrow rows piled up; a width that is not a multiple of 4;
    windows cut by n_out (not a multiple of 4); no lanes; n_out = 0; more
    lanes than one running-max chunk of 2048 (3,000) and than the plan
    stages in shared memory (5,000, with a live start re-pointed across a
    chunk boundary).  Every float32 case has at most one nonzero term per
    output element."""
    rng = np.random.default_rng(sum(map(ord, cid)))
    dtype = np.float32 if cid.endswith("-f32") else np.int32
    base = cid.rsplit("-", 1)[0] if cid.endswith(("-f32", "-i32")) else cid
    if base == "frames":  # FLAC's stereo PCM rows: starts at k * 8192
        W, n_live = 8192, 14
        starts = np.zeros(n_live + 6, np.int32)
        starts[:n_live] = np.arange(n_live) * W
        starts[5:] += 3 * W  # a gap: tiles with no lane
        upd = np.zeros((starts.size, W), dtype)
        upd[:n_live] = _values(rng, (n_live, W), dtype)
        upd[n_live - 1, W - 100:] = 0  # the last frame is short
        return starts, upd, int(starts.max()) + W + 4096 + 37
    if base == "wide-unaligned":
        return window_case(rng, 24, 9000, 18, dtype=dtype)
    if base == "pile-up":  # 320 padding rows: one tile of 321 rows
        return window_case(rng, 330, 8192, 10, dtype=dtype)
    if base == "truncated":
        starts, upd, n_out = window_case(rng, 24, 8192, 20, dtype=dtype)
        return starts, upd, int(starts[12]) + 4099
    if cid == "repointed-nonzero":
        starts, upd, n_out = window_case(rng, 330, 8192, 10)
        starts[6] = starts[5] - 3  # below the lane before it
        upd[200] = rng.integers(-99, 99, size=8192)  # a padding lane
        return starts, upd, n_out
    if cid == "narrow-pile-up":  # 1,500 rows of width 8 on one start
        return window_case(rng, 1600, 8, 100)
    if cid == "odd-width":  # rows that are not 16-byte aligned
        return window_case(rng, 600, 4097, 40)
    if cid == "two-chunk-lanes":
        return window_case(rng, 3000, 64, 2500)
    if cid == "many-lanes":
        starts, upd, n_out = window_case(rng, 5000, 16, 4500)
        starts[2100] = starts[2047] - 1  # below a start of the chunk before
        return starts, upd, n_out
    if cid == "no-lanes":
        return np.zeros(0, np.int32), np.zeros((0, 8192), np.float32), 4099
    if cid == "n-out-0":
        return window_case(rng, 6, 8192, 4, dtype=np.float32)[:2] + (0,)
    raise KeyError(cid)


def spmd_shards(rng, lanes, W, live, dtype=np.int32, order=None,
                frames=False):
    """Lane sets as K5 gets them, one per data shard: shard k has
    ``lanes[k]`` lanes, the first ``live[k]`` of them live windows that tile
    the shard's own output range (``window_case``; with ``frames``, full
    rows at multiples of W, like FLAC's stereo frames), the rest padding
    lanes at start 0.  The ranges follow each other in the output in the
    shard order ``order`` (default: 0, 1, ...), so a shard's starts may lie
    below the shard's before it.  Returns ([(starts, upd), ...], the end of
    the last range)."""
    order = list(range(len(lanes))) if order is None else order
    sets, sizes = [], []
    for L, n_live in zip(lanes, live):
        if frames:
            starts = np.zeros(L, np.int32)
            starts[:n_live] = np.arange(n_live) * W
            upd = np.zeros((L, W), dtype)
            upd[:n_live] = _values(rng, (n_live, W), dtype)
            size = n_live * W + 4096 + 37
        else:
            starts, upd, size = window_case(rng, L, W, n_live, dtype=dtype)
        sets.append((starts, upd))
        sizes.append(size)
    at = 0
    for k in order:
        starts, _ = sets[k]
        starts[:live[k]] += at
        at += sizes[k]
    return sets, at


#: ids of ``spmd_case``: K5's own edges
SPMD_CASES = ("frames-f32", "frames-i32", "unordered-f32", "unordered-i32",
              "eight-shards-f32", "eight-shards-i32",
              "padding-shard-between-f32", "padding-shard-between-i32",
              "pile-up-middle-f32", "pile-up-middle-i32", "truncated-f32",
              "truncated-i32", "odd-width-f32", "two-chunk-shards-i32",
              "narrow-pile-ups-i32", "uneven-shards-i32", "overlap-i32",
              "no-lanes-f32", "n-out-0-f32")


def spmd_case(cid: str):
    """([(starts, upd), ...] per data shard, n_out) of K5's edge ``cid``,
    from a fixed numpy seed: FLAC's frame rows over 4 shards; shards whose
    output ranges come in another order than the shards (shard 1 below
    shard 0); 8 shards; a padding-only shard of 330 rows between live ones
    (its zeros pile onto start 0, in tiles that also hold shard 0's rows);
    320 padding rows piled onto the last live start of a middle shard (a
    tile of 321 rows); n_out cutting the last windows; rows that are not 16-byte aligned; shards of more lanes than one
    running-max chunk with a start below one of the chunk before; narrow
    rows piled up in every shard; shards of other lengths, one empty;
    int32 windows that overlap within and across shards (exact on any
    input); no lanes; n_out = 0.  Every float32 case has at most one
    nonzero term per output element."""
    rng = np.random.default_rng(sum(map(ord, cid)) + 1)
    dtype = np.float32 if cid.endswith("-f32") else np.int32
    base = cid.rsplit("-", 1)[0]
    if base == "frames":
        return spmd_shards(rng, [20] * 4, 8192, [14, 14, 14, 8], dtype,
                           frames=True)
    if base == "unordered":
        return spmd_shards(rng, [24] * 4, 1000, [20, 18, 24, 9], dtype,
                           order=[1, 0, 3, 2])
    if base == "eight-shards":
        return spmd_shards(rng, [16] * 8, 700, [16, 3, 12, 0, 16, 9, 5, 14],
                           dtype, order=[2, 0, 1, 3, 7, 6, 5, 4])
    if base == "padding-shard-between":
        return spmd_shards(rng, [330] * 3, 8192, [12, 0, 7], dtype)
    if base == "pile-up-middle":
        return spmd_shards(rng, [330] * 3, 8192, [20, 10, 30], dtype)
    if base == "truncated":
        sets, n_out = spmd_shards(rng, [24] * 4, 8192, [20, 16, 20, 20], dtype)
        return sets, int(sets[3][0][17]) + 4099
    if base == "odd-width":
        return spmd_shards(rng, [150] * 4, 4097, [40, 10, 0, 40], dtype)
    if base == "two-chunk-shards":
        sets, n_out = spmd_shards(rng, [3000] * 3, 64, [2500, 3000, 2000],
                                  dtype)
        sets[1][0][2100] = sets[1][0][2047] - 1  # below the chunk before
        return sets, n_out
    if base == "narrow-pile-ups":
        return spmd_shards(rng, [1600] * 4, 8, [100, 1600, 30, 100], dtype)
    if base == "uneven-shards":
        return spmd_shards(rng, [5, 0, 40, 17], 300, [5, 0, 31, 17], dtype)
    if base == "overlap":
        sets = []
        for L in (60, 45, 70):
            starts = np.sort(rng.integers(0, 30000, size=L)).astype(np.int32)
            sets.append((starts, _values(rng, (L, 2000), dtype)))
        return sets, 32000 - 3
    if base == "no-lanes":
        return [(np.zeros(0, np.int32), np.zeros((0, 8192), dtype))] * 4, 4099
    if base == "n-out-0":
        return spmd_shards(rng, [6] * 4, 8192, [4] * 4, dtype)[0], 0
    raise KeyError(cid)


def _values(rng, shape, dtype):
    if dtype == np.int32:
        return rng.integers(-10**6, 10**6, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _lanes(path: str, dev, corrupt: bool = False):
    """One fixture's scan inputs (decode_spectra's first 11 arguments)."""
    blob = open(path, "rb").read()
    p = native.probe(blob)
    r = native.lanes_batch([blob], D._bucket(p["n_granules"]),
                           D._bucket(p["main_bytes"], 1024), p["channels"])
    if corrupt:
        rng = np.random.default_rng(3)
        m = r["main"]
        flips = rng.integers(0, p["main_bytes"], size=p["main_bytes"] // 2)
        m[0, flips] ^= (1 << rng.integers(0, 8, size=flips.size)).astype(np.uint8)
    n = r["start"].size
    start = r["start"].reshape(n).astype(np.int32)
    cols = [np.zeros(n, np.int32), start, r["end"].reshape(n), r["limit"].reshape(n),
            r["big"].reshape(n), r["r1"].reshape(n), r["r2"].reshape(n),
            r["tsel"].reshape(n, 3), r["c1sel"].reshape(n), r["valid"].reshape(n)]
    t = [torch.as_tensor(np.ascontiguousarray(c, np.int32), device=dev) for c in cols]
    return [torch.as_tensor(r["main"], device=dev)] + t


@pytest.mark.parametrize("path", FIXTURES, ids=["stereo", "lsf"])
@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
@pytest.mark.parametrize("n_big,n_c1", [(512, 144), (64, 40)])
def test_entropy_kernel_matches_plain(cuda_device, path, corrupt, n_big, n_c1):
    args = _lanes(path, cuda_device, corrupt)
    before = HK.launches
    got = HK.entropy_scan(*args, n_big=n_big, n_c1=n_c1)
    assert HK.launches == before + 1
    ref = HD.scan_plain(*args, n_big=n_big, n_c1=n_c1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("seed", range(4))
def test_entropy_kernel_matches_plain_on_random_lanes(cuda_device, seed):
    """Garbage bytes with random side info (start past end, limit before
    end, reserved tables, big_values up to 511, invalid lanes, several
    files per batch)."""
    rng = np.random.default_rng(seed)
    n, files, width = 4096, 3, 16384
    main = rng.integers(0, 256, size=(files, width), dtype=np.uint8)
    start = rng.integers(0, 8 * (width - 2000), size=n)
    end = start + rng.integers(-50, 4000, size=n)
    limit = end + rng.integers(-20, 300, size=n)
    r1 = rng.integers(0, 577, size=n)
    cols = [rng.integers(0, files, size=n), start, end, limit,
            rng.integers(0, 512, size=n), r1,
            np.maximum(r1, rng.integers(0, 577, size=n)),
            rng.integers(0, 32, size=(n, 3)), rng.integers(0, 2, size=n),
            rng.random(n) < 0.9]
    args = [torch.as_tensor(main, device=cuda_device)] + [
        torch.as_tensor(np.ascontiguousarray(c, np.int32), device=cuda_device)
        for c in cols]
    for n_big, n_c1 in ((512, 144), (96, 72)):
        got = HK.entropy_scan(*args, n_big=n_big, n_c1=n_c1)
        ref = HD.scan_plain(*args, n_big=n_big, n_c1=n_c1)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert 0 < int(got[2].sum()) < n


def _random_scan_args(rng, dev, main, n, start, tables, span=3000):
    """Scan arguments for ``n`` lanes on the rows of ``main`` (a u8 [B, M]
    tensor, possibly a view), starting at ``start`` and ending up to
    ``span`` bits later, with every region's table drawn from ``tables``."""
    end = start + rng.integers(0, span, size=n)
    limit = end + rng.integers(0, 300, size=n)
    r1 = rng.integers(0, 577, size=n)
    cols = [rng.integers(0, main.shape[0], size=n), start, end, limit,
            rng.integers(0, 400, size=n), r1, rng.integers(0, 577, size=n),
            rng.choice(tables, size=(n, 3)), rng.integers(0, 2, size=n),
            np.ones(n)]
    return [main] + [torch.as_tensor(np.ascontiguousarray(c, np.int32), device=dev)
                     for c in cols]


def test_entropy_kernel_lanes_reaching_the_row_end(cuda_device):
    """An odd row width on a base that is not 16-byte aligned, lanes that
    start in the last bytes of their row, past it and before it: the
    kernel's 16-byte chunks there are assembled byte by byte, and bytes
    outside the row read as 0, as in the plain scan."""
    rng = np.random.default_rng(31)
    files, width, n = 3, 1001, 2048
    flat = torch.as_tensor(rng.integers(0, 256, size=files * width + 5,
                                        dtype=np.uint8), device=cuda_device)
    main = flat[5:].view(files, width)
    assert main.data_ptr() % 16 != 0
    start = rng.integers(8 * (width - 200), 8 * width + 64, size=n)
    start[:16] = rng.integers(-64, 0, size=16)
    args = _random_scan_args(rng, cuda_device, main, n, start,
                             [1, 7, 13, 15, 16, 23, 24, 31])
    got = HK.entropy_scan(*args)
    ref = HD.scan_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert 0 < int(got[2].sum()) < n


def test_entropy_kernel_lanes_longer_than_a_staging_slot(cuda_device):
    """Spans of up to 12,000 bits, past the 4,095 of part2_3 and past the
    kernel's 544-byte staging slot per lane: such lanes read their bits
    from global memory instead, with the same results."""
    rng = np.random.default_rng(37)
    n = 512
    main = torch.as_tensor(rng.integers(0, 256, size=(2, 4096), dtype=np.uint8),
                           device=cuda_device)
    start = rng.integers(0, 8 * 2048, size=n)
    args = _random_scan_args(rng, cuda_device, main, n, start, [1, 5, 12, 15],
                             span=12000)
    got = HK.entropy_scan(*args, n_big=512, n_c1=144)
    ref = HD.scan_plain(*args, n_big=512, n_c1=144)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    unstaged = (args[3] - args[2]).cpu().numpy() > 4400
    assert unstaged.sum() > 100 and not got[2].cpu()[torch.as_tensor(unstaged)].all()


@pytest.mark.parametrize("table", [13, 15, 16, 24])
def test_entropy_kernel_codes_longer_than_the_first_level(cuda_device, table):
    """Random bytes under the tables whose codes outgrow the 10-bit first
    level: some pairs decode through a second-level subtable (values that
    only codes longer than 10 bits carry), and every lane matches."""
    rng = np.random.default_rng(table)
    n = 1024
    main = torch.as_tensor(rng.integers(0, 256, size=(2, 16384), dtype=np.uint8),
                           device=cuda_device)
    start = rng.integers(0, 8 * 12000, size=n)
    args = _random_scan_args(rng, cuda_device, main, n, start, [table])
    got = HK.entropy_scan(*args, n_big=512, n_c1=144)
    ref = HD.scan_plain(*args, n_big=512, n_c1=144)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    long_xy = {xy for xy, (ln, _c) in HT.BIG_TABLES[table].items()
               if ln > HD.L1_BITS and 0 < min(xy) and max(xy) < 15}
    pairs = got[0].reshape(n, 288, 2).abs().cpu().numpy().reshape(-1, 2)
    assert any(tuple(p) in long_xy for p in pairs)


def test_entropy_kernel_reserved_and_invalid_lanes(cuda_device):
    args = _lanes(FIXTURES[0], cuda_device)
    tsel, valid = args[8].clone(), args[10].clone()
    live = torch.nonzero(valid > 0).flatten()
    tsel[live[0], 0] = 4
    tsel[live[1], 1] = 14
    valid[live[2]] = 0
    args[8], args[10] = tsel, valid
    got = HK.entropy_scan(*args)
    ref = HD.scan_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert bool(got[2][live[0]]) and bool(got[2][live[2]])


@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 513,
                               1000])
def test_synthesis_kernel_matches_plain(cuda_device, T):
    rng = np.random.default_rng(T)
    c = dsp._consts(cuda_device)
    ts = torch.as_tensor(rng.standard_normal((5, T, 32)).astype(np.float32),
                         device=cuda_device)
    before = SK.launches
    got = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    assert SK.launches == before + 1
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("frames,steps", [(2048, 12), (512, 36)],
                         ids=["layer1", "layer2"])
def test_synthesis_kernel_at_the_layer12_shapes(cuda_device, frames, steps):
    """K2 at the Layer I/II path's long rows (T = frames·steps, 16 rows)."""
    rng = np.random.default_rng(frames + steps)
    c = dsp._consts(cuda_device)
    ts = torch.as_tensor(
        rng.standard_normal((16, frames * steps, 32)).astype(np.float32),
        device=cuda_device)
    got = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def test_synthesis_kernel_on_an_unaligned_view(cuda_device):
    """TS one float into its storage (not 16-byte aligned): the wrapper
    copies it, the kernel reads 16-byte words."""
    rng = np.random.default_rng(5)
    c = dsp._consts(cuda_device)
    flat = torch.as_tensor(rng.standard_normal(4 * 300 * 32 + 1).astype(np.float32),
                           device=cuda_device)
    ts = flat[1:].view(4, 300, 32)
    assert ts.data_ptr() % 16 != 0
    got = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def test_synthesis_wrapper_refuses_a_matrix_without_the_symmetry(cuda_device):
    c = dsp._consts(cuda_device)
    ts = torch.zeros((2, 8, 32), device=cuda_device)
    n_mat = c["synth_n"].clone()
    n_mat[5, 7] += 0.5
    with pytest.raises(ValueError, match="symmetry"):
        SK.polyphase_synthesis_blocks(ts, n_mat, c["g2"])
    n_mat.copy_(c["synth_n"])  # in place: a new version, folded anew
    SK.polyphase_synthesis_blocks(ts, n_mat, c["g2"])


def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    c = dsp._consts(cuda_device)
    ts = torch.zeros((2, 8, 32), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    args = _lanes(FIXTURES[1], cuda_device)
    args[2] = args[2].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        HK.entropy_scan(*args)


def test_decode_paths_cuda_matches_cpu(cuda_device):
    k1, k2 = HK.launches, SK.launches
    gpu = decode_paths(FIXTURES, device=cuda_device)
    assert HK.launches > k1 and SK.launches > k2  # K1 and K2 on the card
    cpu = decode_paths(FIXTURES, device="cpu")
    assert gpu.data.device.type == "cuda"
    assert gpu.names == cpu.names
    for k in ("sample_rate", "num_channels", "valid_frames", "err"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k))
    for i in range(len(FIXTURES)):
        ref, got = cpu.file(i).pcm, gpu.file(i).pcm
        rms = float(np.sqrt(((ref - got) ** 2).mean()))
        bar = 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
        assert rms < bar, (i, rms, bar)


def test_decode_group_hosthuff_cuda_matches_cpu(cuda_device):
    """The host-Huffman route on the card against its CPU run on both
    fixtures and a broken file: K2 once per group and no K1, the int8
    stereo and block bytes copied to the card, metadata and error codes
    equal, PCM within the RMS bar."""
    from audio_decoder_tpu_torch.io.assets import Asset

    assets = [Asset(path=p, name=os.path.basename(p).split(".")[0], ext="mp3",
                    data=open(p, "rb").read()) for p in FIXTURES]
    assets.append(Asset(path="bad.mp3", name="bad", ext="mp3",
                        data=bytes(range(256)) * 16))
    k1, k2 = HK.launches, SK.launches
    gpu = D.decode_group_hosthuff(assets, device=cuda_device)
    torch.cuda.synchronize()
    assert (HK.launches - k1, SK.launches - k2) == (0, 2)  # joint, mono
    cpu = D.decode_group_hosthuff(assets, device="cpu")
    assert [i for i, _ in gpu] == [i for i, _ in cpu]
    for (_, g), (_, c) in zip(gpu, cpu):
        assert g.data.device.type == "cuda" and g.names == c.names
        for k in ("sample_rate", "num_channels", "bits_per_sample",
                  "valid_frames", "err"):
            assert torch.equal(getattr(g, k).cpu(), getattr(c, k)), k
        ref, got = c.data.numpy(), g.data.cpu().numpy()
        assert got.shape == ref.shape
        rms = float(np.sqrt(((ref - got) ** 2).mean()))
        bar = 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
        assert rms < bar, (g.names, rms, bar)


def test_other_families_cuda_match_cpu(cuda_device, tmp_path):
    """AIFF, AIFF-C ima4, AU, CAF, WAV IMA and MS ADPCM bit for bit and
    Layers I/II within the RMS bar, the card against the CPU path."""
    from . import ima_ref as IR
    from . import ms_ref as MR
    from .seeded_writers import (ima_wav, layer1_frames, layer2_frames,
                                 ms_wav)
    from .synth import make_aiff, make_au, make_caf

    rng = np.random.default_rng(0xFA)
    pcm = rng.integers(-30000, 30000, size=(3000, 2)).astype(np.int16)
    files = {
        "a.aif": make_aiff(pcm.astype(np.int64), 44100, 16),
        "b.aifc": make_aiff(np.zeros((0, 2), np.int16), 44100, 16,
                            compression=b"ima4",
                            data_override=IR.encode_ima4(pcm),
                            frames_override=3000),
        "c.au": make_au(pcm.astype(np.int64), 22050, 3),
        "d.caf": make_caf(pcm.astype(np.int64), 48000, bits=16, little=True),
        "e.wav": ima_wav(IR.encode(pcm, 1024), 2, 1024),
        "f.wav": ms_wav(MR.encode(pcm, 1024), 2, 1024),
        "g.mp1": layer1_frames(rng, 12, 2),
        "h.mp2": layer2_frames(rng, 6, 2),
    }
    paths = []
    for name, blob in files.items():
        (tmp_path / name).write_bytes(blob)
        paths.append(str(tmp_path / name))
    before = SK.launches
    gpu = decode_paths(paths, device=cuda_device)
    assert SK.launches > before  # Layer I/II synthesis ran on the card
    cpu = decode_paths(paths, device="cpu")
    assert gpu.names == cpu.names and gpu.formats == cpu.formats
    for k in ("sample_rate", "num_channels", "valid_frames", "err"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k))
    assert int(gpu.err.abs().sum()) == 0
    for i, fmt in enumerate(gpu.formats):
        ref, got = cpu.file(i).pcm, gpu.file(i).pcm
        if fmt in ("mp1", "mp2"):
            rms = float(np.sqrt(((ref - got) ** 2).mean()))
            bar = 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
            assert rms < bar, (i, rms, bar)
        else:
            np.testing.assert_array_equal(got, ref)


def _on(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in arrays]


def _window_cases():
    """(id, starts, upd, n_out): the CPU tests' cases plus the kernel's own
    edges — tile boundaries, a pile-up of padding lanes on one start that
    spreads one tile over many blocks, truncation, no lanes."""
    cases = []
    for seed, L, W, n_live in WINDOW_CASES:
        cases.append((f"i32-{seed}", *window_case(np.random.default_rng(seed),
                                                  L, W, n_live)))
    cases.append(("f32-frames", *window_case(np.random.default_rng(7), 48, 2048,
                                             31, dtype=np.float32)))
    rng = np.random.default_rng(11)
    for tile in (4096, TPU_TILE):
        starts = np.asarray([0, tile - 100, tile - 1, 2 * tile - 511], np.int32)
        cases.append((f"tile-{tile}", starts,
                      rng.integers(-9, 9, size=(4, 512)).astype(np.int32),
                      2 * tile + 512))
    cases.append(("pile-up", *window_case(np.random.default_rng(12), 12000,
                                          256, 300)))
    cases.append(("truncated", np.asarray([0, 6, 9], np.int32),
                  np.arange(1, 13, dtype=np.int32).reshape(3, 4), 11))
    cases.append(("repointed", np.asarray([0, 10, 5, 0], np.int32),
                  np.arange(1, 17, dtype=np.int32).reshape(4, 4), 20))
    cases.append(("no-lanes", np.zeros(0, np.int32),
                  np.zeros((0, 16), np.int32), 100))
    return cases


@pytest.mark.parametrize("case", _window_cases(), ids=lambda c: c[0])
def test_window_add_kernel_matches_plain(cuda_device, case):
    _, starts, upd, n_out = case
    s, u = _on(cuda_device, starts, upd)
    before = PW.launches["window_add"]
    got = PW.window_add(s, u, n_out)
    assert PW.launches["window_add"] == before + 1
    ref = PW.window_add_plain(s, u, n_out)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("seed,Wa,Wb", [(5, 256, 8), (6, 520, 96), (8, 4096, 8)])
def test_window_add2_kernel_matches_plain(cuda_device, seed, Wa, Wb):
    rng = np.random.default_rng(seed)
    sa, ua, na = window_case(rng, 192, Wa, 150)
    sb, ub, nb = window_case(rng, 64, Wb, 40)
    n_out = max(na, nb)
    args = _on(cuda_device, sa, ua, sb, ub)
    before = PW.launches["window_add2"]
    got = PW.window_add2(*args, n_out)
    assert PW.launches["window_add2"] == before + 1
    ref = PW.window_add2_plain(*args, n_out)
    two = (PW.window_add_plain(args[0], args[1], n_out)
           + PW.window_add_plain(args[2], args[3], n_out))
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, two)


def test_window_add_kernels_at_the_flac_group_shapes(cuda_device):
    """K4 and K3 on the 16-file FLAC group's own inputs (value assembly
    int32 [65536, 256] + [4096, 8], PCM assembly f32 [2048, 8192])."""
    blob = open(FLAC_FIXTURES[0], "rb").read()
    args, st = FD.pack_wire(FF.analyze_batch([blob] * 16), cuda_device)
    w = FV.flac_decode_wire(*args, stage="windows", **st)
    assert tuple(w["window_add2"][1].shape) == (65536, 256)
    assert tuple(w["window_add"][1].shape) == (2048, 8192)
    for fn, plain, key in ((PW.window_add2, PW.window_add2_plain, "window_add2"),
                           (PW.window_add, PW.window_add_plain, "window_add")):
        got, ref = fn(*w[key]), plain(*w[key])
        torch.cuda.synchronize()
        assert torch.equal(got, ref), key


def test_window_add_kernel_at_the_mono_group_shapes(cuda_device):
    """K3 on the 24-bit mono fixture's own PCM inputs (the second FLAC
    group's shapes: one channel, 48 frame rows of 4096)."""
    blob = open(FLAC_FIXTURES[1], "rb").read()
    args, st = FD.pack_wire(FF.analyze_batch([blob]), cuda_device)
    starts, upd, n_out = FV.flac_decode_wire(*args, stage="windows",
                                             **st)["window_add"]
    got = PW.window_add(starts, upd, n_out)
    ref = PW.window_add_plain(starts, upd, n_out)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def window2_cases():
    """(id, starts_a, upd_a, starts_b, upd_b, n_out): K4's edges.  Cases
    whose id starts with "unaligned" are run on update arrays that begin
    one element into their storage (``unaligned_view``)."""
    rng = np.random.default_rng(21)
    cases = []
    sb, ub, nb = window_case(rng, 64, 8, 40)
    # 2,700 zero padding lanes re-pointed onto the last live start: a pile-up
    # of about 42 units, more than one group of partials
    sa, ua, na = window_case(rng, 3000, 256, 300)
    cases.append(("pile-up", sa, ua, sb, ub, max(na, nb)))
    # a live lane whose start falls below the one before it, and a padding
    # lane inside the pile-up, both with nonzero updates: re-pointed and added
    sa2, ua2 = sa.copy(), ua.copy()
    sa2[150] = sa2[149] - 5
    ua2[150] = rng.integers(-99, 99, size=256)
    ua2[2500] = rng.integers(-99, 99, size=256)
    cases.append(("repointed-pile-up", sa2, ua2, sb, ub, max(na, nb)))
    # 1,400 zero padding lanes of width 8 on one start, one of them nonzero
    # (the fixed-width lanes' pile-up: narrow rows, many of them)
    sn, un, nn = window_case(rng, 1500, 8, 100)
    un[1200] = rng.integers(-99, 99, size=8)
    cases.append(("narrow-pile-up", sa[:300], ua[:300], sn, un, max(na, nn)))
    sb3, ub3, nb3 = window_case(rng, 50, 3, 40)
    for W in (7, 13, 96):
        sw, uw, nw = window_case(rng, 400, W, 350)
        cases.append((f"unaligned-{W}", sw, uw, sb3, ub3, max(nw, nb3)))
    cases.append(("empty-b", sa, ua, np.zeros(0, np.int32),
                  np.zeros((0, 8), np.int32), na))
    cases.append(("empty-a", np.zeros(0, np.int32), np.zeros((0, 256), np.int32),
                  sb, ub, nb))
    cases.append(("cut", sa, ua, sb, ub, int(sa[299]) + 100))
    for W, L, live in ((4096, 24, 20), (8200, 16, 12)):
        sw, uw, nw = window_case(rng, L, W, live)
        cases.append((f"wide-{W}", sw, uw, sb, ub, max(nw, nb)))
    # float32, overlapping nonzero windows and a pile-up of nonzero lanes
    La = 200
    sf = np.concatenate([np.sort(rng.integers(0, 3000, size=La)),
                         np.full(600, 2990)]).astype(np.int32)
    uf = rng.standard_normal((sf.size, 64)).astype(np.float32)
    sfb = np.sort(rng.integers(0, 3000, size=50)).astype(np.int32)
    ufb = rng.standard_normal((50, 8)).astype(np.float32)
    cases.append(("f32-overlap", sf, uf, sfb, ufb, 3100))
    return cases


def unaligned_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a tensor that starts one element into its storage."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def window2_matches(got, arrays, n_out) -> bool:
    """Exact against window_add2_plain and the two single-set twins (int32);
    float32 within 2e-3 of the float64 sum (rounding of sums of up to ~700
    terms of magnitude ~1, in another order)."""
    sa, ua, sb, ub = arrays
    if got.dtype == torch.float32:
        ref = PW.window_add2_plain(sa, ua.double(), sb, ub.double(), n_out)
        return bool(torch.allclose(got.double(), ref, atol=2e-3, rtol=1e-5))
    ref = PW.window_add2_plain(*arrays, n_out)
    two = PW.window_add_plain(sa, ua, n_out) + PW.window_add_plain(sb, ub, n_out)
    return torch.equal(got, ref) and torch.equal(got, two)


@pytest.mark.parametrize("case", window2_cases(), ids=lambda c: c[0])
def test_window_add2_kernel_edges(cuda_device, case):
    cid, *arrays, n_out = case
    arrays = _on(cuda_device, *arrays)
    if cid.startswith("unaligned"):
        arrays[1] = unaligned_view(arrays[1])
        assert arrays[1].data_ptr() % 16 != 0
    before = PW.launches["window_add2"]
    got = PW.window_add2(*arrays, n_out)
    assert PW.launches["window_add2"] == before + 1
    again = PW.window_add2(*arrays, n_out)
    torch.cuda.synchronize()
    assert got.shape == (n_out,) and window2_matches(got, arrays, n_out)
    assert torch.equal(got, again)  # float32 too: one fixed order


def test_window_add2_raises_when_the_kernel_fails(cuda_device, monkeypatch):
    """No fallback: a launch that returns a CUDA error raises, and so does
    a library that cannot be built."""
    from audio_decoder_tpu_torch.utils import build

    s, u = _on(cuda_device, np.zeros(4, np.int32), np.zeros((4, 8), np.int32))

    class Failing:
        @staticmethod
        def window_add2_launch(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(PW, "load_library2", lambda: Failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PW.window_add2(s, u, s, u, 16)
    monkeypatch.undo()

    def no_nvcc():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(build.BuildError):
        PW.window_add2(s, u, s, u, 16)


@pytest.mark.parametrize("cid", WINDOW1_CASES + ("unaligned-view",))
def test_window_add_kernel_edges(cuda_device, cid):
    """K3 against its twin on its own edges: int32 exactly, float32 exactly
    (one nonzero term per element); called twice, the same bits.
    ``unaligned-view`` runs the pile-up on updates that begin one element
    into their storage (the 4-byte path)."""
    starts, upd, n_out = window1_case("pile-up-f32" if cid == "unaligned-view"
                                      else cid)
    s, u = _on(cuda_device, starts, upd)
    if cid == "unaligned-view":
        u = unaligned_view(u)
        assert u.data_ptr() % 16 != 0
    before = PW.launches["window_add"]
    got = PW.window_add(s, u, n_out)
    assert PW.launches["window_add"] == before + 1
    again = PW.window_add(s, u, n_out)
    ref = PW.window_add_plain(s, u, n_out)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == (n_out,)
    assert torch.equal(got, ref)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_window_add_raises_when_the_kernel_fails(cuda_device, monkeypatch):
    """No fallback: a launch that returns a CUDA error raises and counts no
    launch, and so does a library that cannot be built."""
    from audio_decoder_tpu_torch.utils import build

    s, u = _on(cuda_device, np.zeros(4, np.int32), np.zeros((4, 8), np.int32))

    class Failing:
        @staticmethod
        def window_add_launch(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(PW, "load_library", lambda: Failing)
    before = PW.launches["window_add"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PW.window_add(s, u, 16)
    assert PW.launches["window_add"] == before
    monkeypatch.undo()

    def no_nvcc():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(build.BuildError):
        PW.window_add(s, u, 16)


def test_window_add_rejects_bad_inputs(cuda_device):
    s, u = _on(cuda_device, np.zeros(4, np.int32), np.zeros((4, 8), np.int32))
    with pytest.raises(ValueError, match="int32"):
        PW.window_add(s.to(torch.int64), u, 16)
    with pytest.raises(ValueError, match="int32 or float32"):
        PW.window_add(s, u.to(torch.float64), 16)
    with pytest.raises(ValueError, match="contiguous"):
        PW.window_add(s, u.t().contiguous().t(), 16)
    with pytest.raises(ValueError, match="one dtype"):
        PW.window_add2(s, u, s, u.to(torch.float32), 16)


def test_flac_decode_paths_cuda_matches_cpu(cuda_device):
    """Both FLAC fixtures (narrow and wide rice scan) decode on the card bit
    for bit as on the CPU, through K3 and K4."""
    before = dict(PW.launches)
    gpu = decode_paths(FLAC_FIXTURES, device=cuda_device)
    assert all(PW.launches[k] > before[k] for k in ("window_add", "window_add2"))
    cpu = decode_paths(FLAC_FIXTURES, device="cpu")
    assert gpu.names == cpu.names
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    assert torch.equal(gpu.data.cpu(), cpu.data)


def test_flac_chunked_route_cuda_matches_cpu(cuda_device, monkeypatch):
    """The music fixture past a shrunken ``BIT_CAP`` decodes frame-chunked
    (K3, K4 and the predictor once per chunk) on the card bit for bit as
    on the CPU."""
    path = FLAC_FIXTURES[0]
    monkeypatch.setattr(FF, "BIT_CAP", 8 * os.path.getsize(path))
    before = PW.launches["window_add"]
    before_p1 = PP.launches["flac_predict"]
    gpu = decode_paths([path], device=cuda_device)
    assert PW.launches["window_add"] - before > 1  # one launch per chunk
    assert (PP.launches["flac_predict"] - before_p1
            == PW.launches["window_add"] - before)
    cpu = decode_paths([path], device="cpu")
    assert int(gpu.err[0]) == 0 and int(cpu.err[0]) == 0
    assert np.array_equal(gpu.file(0).pcm, cpu.file(0).pcm)
    assert int(gpu.valid_frames[0]) == int(cpu.valid_frames[0]) == 441000


# ---------------------------------------------------------------------------
# The FLAC rice scan kernel (csrc/flac_rice.cu)
# ---------------------------------------------------------------------------

#: ids of ``rice_case``
RICE_CASES = ("narrow", "wide", "narrow-long", "wide-long", "wide-odd-width",
              "no-lanes", "no-steps")


def rice_case(cid: str):
    """(stream u8, bitpos i32, count i32, param i32, limit i64, steps,
    narrow) of the rice scan's edge ``cid``, from a fixed numpy seed: 300
    random lanes (more than two blocks of 128, the last warp partial) over
    a random stream with a zero run, rice parameters up to 16 (narrow) or
    30 (wide), widths of one chunk of 32 codes, of 8 chunks (the loader's
    256 codes), and 258 and 18 (a partial last chunk); rows 0-1 sit in the
    zero run (all-zero windows: overflow), row 2 has count 0 and row 3
    count = steps*K, rows 4-9 a limit a few codes on (their cursors reach
    it inside a step), rows 10-14 a bitpos within 5 bytes of the stream's
    end, rows 15-16 the variant's largest parameter and 0, row 17 a limit
    below its bitpos; no lanes; no steps."""
    narrow = not cid.startswith("wide")
    steps = {"narrow": 4, "wide": 4, "narrow-long": 32, "wide-long": 43,
             "wide-odd-width": 3, "no-lanes": 4, "no-steps": 0}[cid]
    W = steps * FV.rice_k(narrow)
    pmax = 16 if narrow else 30
    L = 0 if cid == "no-lanes" else 300
    rng = np.random.default_rng(40 + RICE_CASES.index(cid))
    n = 20000
    stream = rng.integers(0, 256, size=n).astype(np.uint8)
    stream[1000:1040] = 0
    bitpos = rng.integers(0, (n - 600) * 8, size=L).astype(np.int64)
    count = rng.integers(0, W + 1, size=L)
    param = rng.integers(0, pmax + 1, size=L)
    limit = np.full(L, n * 8, np.int64)
    if L:
        bitpos[:2] = 1000 * 8 + np.asarray([0, 37])
        count[2] = 0
        limit[4:10] = bitpos[4:10] + rng.integers(1, 80, size=6)
        bitpos[10:15] = (n - 5) * 8 + rng.integers(0, 40, size=5)
        param[15:17] = (pmax, 0)
        limit[17] = bitpos[17] - 100
        count[[0, 1, 3] + list(range(4, 18))] = W
    return (stream, bitpos.astype(np.int32), count.astype(np.int32),
            param.astype(np.int32), limit, steps, narrow)


def rice_plain(stream, bitpos, count, param, limit, steps, narrow):
    """The plain twin on the CPU and the decode's mask: (values i32
    ``[L, steps*K]`` zero at and past ``count``, ovf bool ``[L]``)."""
    t = [torch.as_tensor(a) for a in (stream, bitpos, count, param, limit)]
    rv, ovf = FV._rice_scan(*t, steps, narrow)
    live = torch.arange(rv.shape[1])[None, :] < t[2][:, None]
    return torch.where(live, rv, 0), ovf


@pytest.mark.parametrize("cid", RICE_CASES)
def test_rice_scan_kernel_matches_plain(cuda_device, cid):
    """One launch per call, the twin's masked values and its overflow bit
    for bit."""
    case = rice_case(cid)
    want_v, want_o = rice_plain(*case)
    before = RS.launches["flac_rice"]
    args = [torch.as_tensor(a).to(cuda_device) for a in case[:5]]
    steps, narrow = case[5:]
    got_v, got_o = RS.rice_scan_cuda(*args, steps, narrow, FV.rice_k(narrow),
                                     FF.Q_CAP)
    torch.cuda.synchronize()
    assert RS.launches["flac_rice"] == before + 1
    assert got_v.dtype == torch.int32 and got_o.dtype == torch.bool
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_o.cpu(), want_o)
    if cid not in ("no-lanes", "no-steps"):  # overflow lanes and clean ones
        assert want_o[:2].all() and not want_o.all()


def test_rice_scan_raises_when_the_kernel_fails(cuda_device, monkeypatch):
    """No fallback: a launch that returns a CUDA error raises."""
    class Failing:
        @staticmethod
        def flac_rice_scan_launch(*args):
            return 700  # cudaErrorIllegalAddress

    args = [torch.as_tensor(a).to(cuda_device) for a in rice_case("narrow")[:5]]
    monkeypatch.setattr(RS, "load_library", lambda: Failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        FV._rice_lanes(*args, 4, True)


@pytest.mark.parametrize("narrow", (True, False))
def test_rice_scan_refuses_another_step_count(cuda_device, narrow):
    """The variant's codes per step are compiled into the kernel: a caller
    that counts the other variant's gets CUDA's invalid-value error and
    nothing launches."""
    args = [torch.as_tensor(a).to(cuda_device) for a in rice_case("narrow")[:5]]
    before = RS.launches["flac_rice"]
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        RS.rice_scan_cuda(*args, 12, narrow, FV.rice_k(not narrow), FF.Q_CAP)
    assert RS.launches["flac_rice"] == before


def _rice_wire_batches():
    """Two batches of files made by the port's own encoder, one narrow
    (16-bit tonal material: rice parameters <= 16) and one wide (24-bit
    tones under loud noise: parameters above 16)."""
    from audio_decoder_tpu_torch.codecs.flac.encode import encode_flac

    rng = np.random.default_rng(19)
    narrow = [encode_flac(flac_music(rng, S), 44100, bits=16, device="cpu")
              for S in (30000, 9000)]
    loud = [(0.4 * np.sin(np.arange(S) * 0.01)[:, None]
             + 0.05 * rng.standard_normal((S, 1))).astype(np.float32)
            for S in (12000, 5000)]
    wide = [encode_flac(x, 48000, bits=24, device="cpu") for x in loud]
    return {True: narrow, False: wide}


def test_flac_decode_wire_with_the_rice_kernel_matches_cpu(cuda_device):
    """A whole ``flac_decode_wire`` on the card, packed by
    ``decoder.pack_wire`` from the port's own encodes, equals the CPU path
    bit for bit in each variant, with one rice launch per call."""
    for narrow, blobs in _rice_wire_batches().items():
        an = [FF.analyze(b) for b in blobs]
        assert FD.sizing_for(an)["rice_narrow"] is narrow
        outs = []
        for dev, launched in (("cpu", 0), (cuda_device, 1)):
            before = RS.launches["flac_rice"]
            args, statics = FD.pack_wire(an, dev)
            pcm, ovf = FV.flac_decode_wire(*args, **statics)
            outs.append((pcm.cpu(), ovf.cpu()))
            assert RS.launches["flac_rice"] == before + launched
        (cp, co), (gp, go) = outs
        assert not co.any() and torch.equal(go, co)
        assert torch.equal(gp, cp)


# ---------------------------------------------------------------------------
# The FLAC predictor kernel (csrc/flac_predict.cu)
# ---------------------------------------------------------------------------

#: the blocksizes (nmax) ``predict_case`` is made at
PREDICT_NMAX = (1, 16, 1152, 3072, 4096)
#: ``predict_case``'s subframes: four full warps and a partial fifth
PREDICT_ROWS = 147


def predict_case(nmax: int):
    """(vals i32 ``[Ls, nmax]``, kind, order, shift, wasted i32 ``[Ls]``,
    coeffs i32 ``[Ls, 32]``) of the predictor's edges at ``nmax``, from a
    fixed numpy seed.  Each warp of 32 subframes walks one order class:
    rows 0-31 VERBATIM and CONSTANT (order 0), 32-63 FIXED 0-4 then LPC
    1-4, 64-95 LPC 5-8, 96-127 LPC 9-16, 128-146 (a partial warp) LPC
    17-32, then 32, a CONSTANT row and an all-zero padding row.  LPC shifts
    run through 0-15; every 7th LPC row has every coefficient at
    +(2^15 - 1) and the next at -(2^15 - 1), the rest are random under
    2^15; residuals are small, within 1,000 of the int32 limits, or
    anywhere in int32, so the cast and the add wrap; wasted bits 0-8 on
    every 4th row and 31 on two."""
    from audio_decoder_tpu_torch.codecs.flac.frontend import FIXED_COEFFS

    L = PREDICT_ROWS
    rng = np.random.default_rng(25 + PREDICT_NMAX.index(nmax))
    r = np.arange(L)
    kind = np.zeros(L, np.int64)
    kind[24:32] = 1
    kind[145] = 1
    order = np.zeros(L, np.int64)
    order[37:64] = 1 + (r[37:64] % 4)
    order[64:96] = 5 + (r[64:96] % 4)
    order[[70, 81]] = (2, 4)
    order[96:128] = 9 + (r[96:128] % 8)
    order[128:144] = np.arange(17, 33)
    order[144] = 32
    shift = np.where(order > 0, r % 16, 0)
    coeffs = np.zeros((L, 32), np.int64)
    top = (1 << 15) - 1
    for i in range(L):
        o = int(order[i])
        coeffs[i, :o] = rng.integers(-top, top + 1, size=o)
        if i % 7 == 0:
            coeffs[i, :o] = top
        elif i % 7 == 1:
            coeffs[i, :o] = -top
    for o in range(5):  # FIXED: the spec's coefficients, shift 0
        order[32 + o], shift[32 + o] = o, 0
        coeffs[32 + o] = 0
        coeffs[32 + o, :o] = FIXED_COEFFS[o]
    wasted = np.where(r % 4 == 0, (r // 4) % 9, 0)
    wasted[[5, 130]] = 31
    lim = 1 << 31
    small = rng.integers(-(1 << 15), 1 << 15, size=(L, nmax))
    near = rng.integers(0, 1000, size=(L, nmax))
    edge = np.where(rng.random((L, nmax)) < 0.5, lim - 1 - near, near - lim)
    anywhere = rng.integers(-lim, lim, size=(L, nmax))
    vals = np.where((r % 3 == 0)[:, None], small,
                    np.where((r % 3 == 1)[:, None], edge, anywhere))
    vals[146] = 0
    return tuple(a.astype(np.int32) for a in
                 (vals, kind, order, shift, wasted, coeffs))


def decode_view(vals: torch.Tensor, offset: int = 3) -> torch.Tensor:
    """``vals`` [Ls, nmax] as the decode holds it: a view of flat values
    with rows ``nmax + 1`` apart, ``offset`` elements into its storage."""
    Ls, nmax = vals.shape
    flat = torch.full((offset + Ls * (nmax + 1),), -7, dtype=vals.dtype,
                      device=vals.device)
    view = flat[offset:].reshape(Ls, nmax + 1)[:, :nmax]
    view.copy_(vals)
    return view


@pytest.mark.parametrize("nmax", PREDICT_NMAX)
@pytest.mark.parametrize("layout", ("decode-view", "contiguous"))
def test_predict_kernel_matches_the_twin(cuda_device, nmax, layout):
    """One launch per call; the samples of the plain twin ``_predict`` on
    the CPU bit for bit, through the decode's strided view and through a
    contiguous array."""
    case = [torch.as_tensor(a) for a in predict_case(nmax)]
    want = FV._predict(*case, nmax)
    vals, *rest = [a.to(cuda_device) for a in case]
    if layout == "decode-view":
        vals = decode_view(vals)
    before = PP.launches["flac_predict"]
    got = FV._predict_lanes(vals, *rest, nmax)
    torch.cuda.synchronize()
    assert PP.launches["flac_predict"] == before + 1
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got.cpu(), want)


def test_predict_raises_when_the_kernel_fails(cuda_device, monkeypatch):
    """No fallback: a launch that returns a CUDA error raises."""
    class Failing:
        @staticmethod
        def flac_predict_launch(*args):
            return 700  # cudaErrorIllegalAddress

    case = [torch.as_tensor(a).to(cuda_device) for a in predict_case(16)]
    monkeypatch.setattr(PP, "load_library", lambda: Failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        FV._predict_lanes(*case, 16)


def test_flac_decode_wire_with_the_predict_kernel_matches_cpu(cuda_device):
    """A whole ``flac_decode_wire`` on the card, packed by
    ``decoder.pack_wire`` from the port's own narrow and wide encodes,
    equals the CPU path bit for bit, with one predictor launch per call."""
    for blobs in _rice_wire_batches().values():
        an = [FF.analyze(b) for b in blobs]
        outs = []
        for dev, launched in (("cpu", 0), (cuda_device, 1)):
            before = PP.launches["flac_predict"]
            args, statics = FD.pack_wire(an, dev)
            pcm, ovf = FV.flac_decode_wire(*args, **statics)
            outs.append((pcm.cpu(), ovf.cpu()))
            assert PP.launches["flac_predict"] == before + launched
        (cp, co), (gp, go) = outs
        assert not co.any() and torch.equal(go, co)
        assert torch.equal(gp, cp)


# ---------------------------------------------------------------------------
# The streams and the batch DSP on the card
# ---------------------------------------------------------------------------


def _cat(chunks) -> np.ndarray:
    return np.concatenate(list(chunks))


def _oneshot(path: str, dev) -> np.ndarray:
    f = decode_paths([path], device=dev).file(0)
    assert f.err == 0
    return f.pcm[:, : f.num_channels]


def _assert_rms(ref, got):
    assert ref.shape == got.shape
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    bar = 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
    assert rms < bar, (rms, bar)


@pytest.mark.parametrize("path", FIXTURES, ids=["stereo", "lsf"])
def test_mp3_stream_cuda_equals_the_oneshot_decode(cuda_device, path):
    """Mp3Stream on the card: one K1 and one K2 launch per chunk, chunks
    equal to the card's one-shot decode bit for bit (also from seeks), and
    within the RMS bar of the CPU stream."""
    blob = open(path, "rb").read()
    one = _oneshot(path, cuda_device)
    st = D.Mp3Stream(blob, granules_per_chunk=64, device=cuda_device)
    k1, k2 = HK.launches, SK.launches
    got = _cat(st)
    n_chunks = -(-st.n_granules // 64)
    assert (HK.launches - k1, SK.launches - k2) == (n_chunks, n_chunks)
    assert np.array_equal(got, one)
    for s in (577, st.total_samples // 2 + 11):
        assert np.array_equal(_cat(st.chunks(start_sample=s)), one[s:])
    _assert_rms(_cat(D.Mp3Stream(blob, granules_per_chunk=64, device="cpu")),
                got)


def test_imdct_product_rows_do_not_depend_on_the_row_count_on_the_card(
        cuda_device):
    """cuBLAS rounds a product of few rows unlike a large one; the fixed-row
    IMDCT product gives every row the same result at any row count."""
    from audio_decoder_tpu_torch.codecs.mpeg import dsp

    R = dsp._MM_ROWS
    g = torch.Generator(device=cuda_device).manual_seed(5)
    a = torch.randn((2 * R + 5, 18), device=cuda_device, generator=g)
    w = dsp._consts(cuda_device)["w_all"][2].t()
    whole = dsp._fixed_rows_mm(a, w)
    for m in (32, 2112, 3232, 32896, R - 1, R, R + 1):
        assert torch.equal(dsp._fixed_rows_mm(a[:m], w), whole[:m]), m
    torch.testing.assert_close(whole, a @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", [1, 2])
def test_l12_stream_cuda_equals_the_oneshot_decode(cuda_device, tmp_path,
                                                   layer):
    from .seeded_writers import layer1_frames, layer2_frames

    rng = np.random.default_rng(40 + layer)
    blob = (layer1_frames(rng, 60, 2) if layer == 1
            else layer2_frames(rng, 40, 2, sr=48000, kbps=256))
    path = tmp_path / f"x.mp{layer}"
    path.write_bytes(blob)
    one = _oneshot(str(path), cuda_device)
    st = D.L12Stream(blob, frames_per_chunk=8, device=cuda_device)
    before = SK.launches
    got = _cat(st)
    assert SK.launches - before == -(-st.n_frames // 8)
    assert np.array_equal(got, one)
    s = 5 * st.spf * 32 + 3
    assert np.array_equal(_cat(st.chunks(start_sample=s)), one[s:])
    _assert_rms(_cat(D.L12Stream(blob, frames_per_chunk=8, device="cpu")),
                got)


def _pcm_stream_files() -> dict:
    """{name: (bytes, extension)}: a WAV, an AIFF 24-bit, an AIFF-C sowt, a
    µ-law AU, a float CAF and the three ADPCM kinds, 3,000 frames each."""
    from . import ima_ref as IR
    from . import ms_ref as MR
    from .seeded_writers import ima_wav, ms_wav
    from .synth import make_aiff, make_au, make_caf, make_wav

    rng = np.random.default_rng(0x57)
    n = 3000
    pcm = rng.integers(-30000, 30000, size=(n, 2)).astype(np.int16)
    z = np.zeros((0, 2), np.int64)
    return {
        "wav16": (make_wav(pcm.astype(np.int64), 44100, 16), "wav"),
        "aiff24": (make_aiff(rng.integers(-(1 << 23), 1 << 23, size=(n, 2)),
                             48000, 24), "aif"),
        "sowt": (make_aiff(pcm.astype(np.int64), 44100, 16,
                           compression=b"sowt"), "aifc"),
        "ulaw": (make_au(np.zeros((0, 1), np.int64), 8000, 1,
                         data_override=rng.integers(0, 256, n).astype(
                             np.uint8).tobytes()), "au"),
        "caf_f32": (make_caf(np.clip(rng.standard_normal((n, 2)) * 0.3, -1, 1),
                             44100, bits=32, little=True, float_=True), "caf"),
        "ima": (ima_wav(IR.encode(pcm, 512), 2, 512), "wav"),
        "ms": (ms_wav(MR.encode(pcm, 512), 2, 512), "wav"),
        "ima4": (make_aiff(z, 44100, 16, compression=b"ima4",
                           data_override=IR.encode_ima4(pcm),
                           frames_override=n // 64 * 64), "aifc"),
    }


PCM_STREAM_FILES = ("wav16", "aiff24", "sowt", "ulaw", "caf_f32", "ima", "ms",
                    "ima4")


@pytest.mark.parametrize("name", PCM_STREAM_FILES)
def test_pcm_stream_cuda_equals_the_oneshot_decode(cuda_device, tmp_path,
                                                   name):
    from audio_decoder_tpu_torch.codecs.pcm_stream import PcmStream

    blob, ext = _pcm_stream_files()[name]
    path = tmp_path / f"x.{ext}"
    path.write_bytes(blob)
    one = _oneshot(str(path), cuda_device)
    st = PcmStream(str(path), frames_per_chunk=500, device=cuda_device)
    got = _cat(st)
    assert np.array_equal(got, one)
    assert np.array_equal(got, _cat(PcmStream(str(path), frames_per_chunk=500,
                                              device="cpu")))
    s = 777
    assert np.array_equal(_cat(st.chunks(start_sample=s)), one[s:])


def test_flac_stream_file_cuda_equals_the_oneshot_decode(cuda_device):
    from audio_decoder_tpu_torch import stream_file

    path = FLAC_FIXTURES[0]
    before = dict(PW.launches)
    got = _cat(stream_file(path, flac_frames_per_chunk=16, device=cuda_device))
    for k in ("window_add", "window_add2"):  # once per chunk of 108 frames
        assert PW.launches[k] - before[k] == -(-108 // 16)
    one = _oneshot(path, cuda_device)
    assert np.array_equal(got, one)
    assert np.array_equal(got, _oneshot(path, "cpu"))
    s = 4096 * 20 + 5
    assert np.array_equal(_cat(stream_file(path, start_sample=s,
                                           device=cuda_device)), one[s:])


def test_stream_decode_and_decode_all_cuda(cuda_device, tmp_path):
    from audio_decoder_tpu_torch import stream_decode
    from audio_decoder_tpu_torch.io.stream import decode_all

    paths = list(FIXTURES) + [FLAC_FIXTURES[1]]
    for name in ("wav16", "ima", "caf_f32"):
        blob, ext = _pcm_stream_files()[name]
        (tmp_path / f"{name}.{ext}").write_bytes(blob)
        paths.append(str(tmp_path / f"{name}.{ext}"))
    whole = decode_paths(paths, device=cuda_device)
    for chunk, batch in stream_decode(paths, files_per_batch=2,
                                      device=cuda_device):
        assert batch.data.device.type == "cuda"
        ref = decode_paths(chunk, device=cuda_device)
        assert batch.names == ref.names and torch.equal(batch.data, ref.data)
    got = decode_all(paths, files_per_batch=2, device=cuda_device)
    assert got.names == whole.names and torch.equal(got.data, whole.data)
    assert torch.equal(got.valid_frames, whole.valid_frames)
    empty = decode_all([], device=cuda_device)
    assert empty.data.device.type == "cuda" and empty.batch_size == 0


def test_stream_file_raises_on_a_device_that_does_not_exist(cuda_device):
    from audio_decoder_tpu_torch import stream_file
    from audio_decoder_tpu_torch.codecs.pcm_stream import PcmStream

    bad = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="CUDA devices exist"):
        list(stream_file(FIXTURES[1], device=bad))
    with pytest.raises(RuntimeError, match="CUDA devices exist"):
        PcmStream(_pcm_stream_files()["wav16"][0], device=bad)


@pytest.mark.parametrize("length", ["floor", "exact"])
def test_resample_to_consensus_cuda_matches_cpu(cuda_device, length):
    """Four source rates to 44.1 kHz on the card against the CPU path: the
    metadata exact, the PCM within max abs 2e-6 and the RMS bar, the row
    already at 44.1 kHz bit for bit; consensus and routing as on the CPU."""
    import dataclasses

    from audio_decoder_tpu_torch import (consensus_for, resample_to_consensus,
                                         route_channels)
    from audio_decoder_tpu_torch.core.batch import AudioBatch

    rates = [48000, 44100, 32000, 22050, 44100]
    frames = [r // 2 for r in rates]
    rng = np.random.default_rng(9)
    pcm = np.zeros((len(rates), max(frames), 2), np.float32)
    for i, (r, n) in enumerate(zip(rates, frames)):
        t = np.arange(n) / r
        pcm[i, :n] = (0.5 * np.sin(2 * np.pi * 1000 * t)[:, None]
                      + 1e-4 * rng.standard_normal((n, 2)))
    meta = dict(sample_rate=rates, num_channels=[2] * 5,
                bits_per_sample=[16] * 5, valid_frames=frames, err=[0] * 5)
    cpu = AudioBatch.from_pcm(torch.as_tensor(pcm), **{
        k: torch.as_tensor(np.asarray(v, np.int32)) for k, v in meta.items()})
    gpu = dataclasses.replace(cpu, **{
        k: getattr(cpu, k).to(cuda_device) for k in ("data", *meta)})
    assert consensus_for(gpu, device=cuda_device) == consensus_for(
        cpu, device="cpu") == (44100, 2)
    a = resample_to_consensus(gpu, 44100, length=length, device=cuda_device)
    b = resample_to_consensus(cpu, 44100, length=length, device="cpu")
    assert a.data.device.type == "cuda"
    for k in meta:
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    got, ref = a.data.cpu().numpy(), b.data.numpy()
    assert float(np.abs(got - ref).max()) <= 2e-6
    _assert_rms(ref, got)
    assert torch.equal(a.data[1, : pcm.shape[1] * 2], gpu.data[1])
    for c_in, c_out in ((1, 2), (2, 1)):
        x = a.pcm[:, :, :c_in].contiguous()
        r = route_channels(x, c_out, device=cuda_device)
        assert r.device.type == "cuda"
        assert float((r.cpu() - route_channels(x.cpu(), c_out, device="cpu"))
                     .abs().max()) <= 1e-6


def test_entropy_kernel_on_a_stream_chunk_cut_at_its_last_byte(cuda_device):
    """The last chunk of an Mp3Stream with its main_data row cut where its
    farthest-reaching lane ends, so that lane ends on the row's last byte;
    then with some lanes stretched past the 544-byte staging slot (read
    from global memory): the kernel equals its twin every time."""
    st = D.Mp3Stream(open(FIXTURES[0], "rb").read(), granules_per_chunk=64,
                     device=cuda_device)
    a = (st.n_granules - 1) // 64 * 64
    args = D.fused_wire_args(st.chunk_wire(a - st.WARMUP, st.n_granules),
                             st._rate_idx, cuda_device)
    lanes = dsp.wire_lane_args(*args[1:10], args[15], args[12])[:10]
    valid = lanes[9] > 0
    reach = int(torch.maximum(lanes[2], lanes[3])[valid].max())
    main = args[0][:, : -(-reach // 8)].contiguous()
    assert main.shape[1] < args[0].shape[1]
    _cnt, nb, nc = st._buckets[0]
    for stretch in (False, True):
        if stretch:
            lanes = [t.clone() for t in lanes]
            idx = torch.nonzero(valid).flatten()[::7]
            lanes[2][idx] += 5000
            lanes[3][idx] += 5000
        got = HK.entropy_scan(main, *lanes, n_big=nb, n_c1=nc)
        ref = HD.scan_plain(main, *lanes, n_big=nb, n_c1=nc)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


# ------------------------------------------------------------ the engine


def engine_case(dev, seed=0, n_tracks=4, seconds=0.5, rate=44100):
    """A 64-voice state on ``dev``: every voice used and started, velocities
    mixed as in the render benchmark (every third voice reversed), gain
    1/64, plus sequencer, tremolo and envelope voices on shared tempo
    lanes, built through the command surface."""
    from audio_decoder_tpu_torch.engine import commands as EC
    from audio_decoder_tpu_torch.engine import state as ES

    rng = np.random.default_rng(seed)
    S = int(seconds * rate)
    tracks = (rng.standard_normal((n_tracks, S, 2)) * 0.1).astype(np.float32)
    names = [f"t{i}" for i in range(n_tracks)]
    st = ES.empty_state(tracks, [S] * n_tracks, [2] * n_tracks,
                        out_channels=2, device=dev)
    reg = ES.HostRegistry(names)
    proc = EC.CmdProcessor(reg, rate)
    # the first n_tracks voices through commands; the other voices are
    # set directly, as bench.py's configuration does
    lines = [f"load {n} -t s:{97 + 13 * i}" for i, n in enumerate(names)]
    lines += ["seq t0 -p 4 -s 0,1,3 -c a:0.6 -j a:0.5", "trem t1 -p 3 -d 0.7",
              "env t2 -p 2 -d 0.8", "velocity t3 -1.3", "tc beat m:50",
              "group g -v t2,t3 -t c:beat", "start -v t0", "start -v t1",
              "start -g g", "start -t beat"]
    for line in lines:
        st = EC.apply(st, reg, proc.parse(line))
    V = ES.MAX_VOICES
    vel = np.where(np.arange(V) % 3 == 0, -1.0, 1.0) * (
        0.25 + 1.75 * rng.uniform(size=V))
    used = torch.ones(V, dtype=torch.bool, device=dev)
    extra = torch.arange(V, device=dev) >= n_tracks
    st = dataclasses.replace(
        st, v_used=used, v_active=used,
        v_track=torch.where(extra, torch.arange(V, device=dev) % n_tracks,
                            st.v_track.long()).to(torch.int32),
        v_pos=torch.where(extra, torch.as_tensor(
            rng.uniform(1000, S - 1000, V), dtype=torch.float32, device=dev),
            st.v_pos),
        v_vel=torch.where(extra, torch.as_tensor(vel, dtype=torch.float32,
                                                 device=dev), st.v_vel),
        v_gain=torch.full((V,), 1.0 / 64, device=dev))
    return st, reg


def test_render_block_cuda_matches_cpu(cuda_device):
    """Card against the port's CPU path: v_active, clock and v_pos equal,
    blocks within max abs 2e-6 (cos/exp and the mix's sums may round
    differently)."""
    from audio_decoder_tpu_torch.engine import render as ER
    from audio_decoder_tpu_torch.engine import state as ES

    st, _ = engine_case(cuda_device)
    cpu = ES.from_numpy(ES.to_numpy(st), "cpu")
    for frames in (128, 4096, 128):
        for _ in range(3):
            gb, st = ER.render_block(st, frames=frames, out_channels=2)
            cb, cpu = ER.render_block(cpu, frames=frames, out_channels=2)
            assert float((gb.cpu() - cb).abs().max()) <= 2e-6
            assert torch.equal(st.v_active.cpu(), cpu.v_active)
            assert torch.equal(st.v_pos.cpu(), cpu.v_pos)
            assert int(st.clock) == int(cpu.clock)


def test_render_chain_cuda_bit_identical_to_sequential(cuda_device):
    from audio_decoder_tpu_torch.engine import render as ER

    st, _ = engine_case(cuda_device, seed=1)
    for frames, depth in ((128, 8), (4096, 4)):
        blks, acts, poss, clocks = ER.render_chain(
            st, frames=frames, out_channels=2, depth=depth)
        cur = st
        for i in range(depth):
            blk, cur = ER.render_block(cur, frames=frames, out_channels=2)
            assert torch.equal(blk, blks[i])
            assert torch.equal(cur.v_active, acts[i])
            assert torch.equal(cur.v_pos, poss[i])
            assert torch.equal(cur.clock, clocks[i])
        st = cur


def test_engine_loop_cuda_speculation_bit_identical(cuda_device, monkeypatch):
    """EngineLoop at SPEC_DEPTH 8 equals SPEC_DEPTH 0 bit for bit on the
    card, with commands landing mid-burst."""
    from audio_decoder_tpu_torch.runtime import loop as LM
    from audio_decoder_tpu_torch.runtime.native import Sink

    script = [("velocity t1 -0.5", 5), ("pause -g g", 9), ("resume -g g", 3),
              ("trem t0 -p 2 -d 0.3", 17), ("stop -v t1", 4), ("start -v t1", 11)]

    def run(depth):
        monkeypatch.setattr(LM, "SPEC_DEPTH", depth)
        st, reg = engine_case(cuda_device, seed=2)
        loop = LM.EngineLoop(st, reg, 44100, 2,
                             sink=Sink("default", 44100, 2, realtime=False))
        out = [loop.run_blocks(6, collect=True)]
        for cmd, n in script:
            assert loop.submit(cmd)
            out.append(loop.run_blocks(n, collect=True))
        assert not loop.errors
        return np.concatenate(out)

    base = run(0)
    assert np.abs(base).max() > 0
    assert np.array_equal(run(8), base)


#: commands of every verb but quit over ``engine_case``'s registry, each
#: with the blocks rendered after it (16 or more reach burst depth 8)
GRAPH_SCRIPT = [("seq t1 -p 4 -s 0,2 -c a:0.5 -j a:0.3", 5), ("velocity t0 -0.7", 9),
                ("pause -g g", 3), ("resume -g g", 17), ("tc beat2 b:300", 0),
                ("trem t3 -p 2 -d 0.4", 11), ("env t1 -p 3 -d 0.5", 8),
                ("stop -v t1", 4), ("start -v t1", 16), ("pause -v t0", 2),
                ("resume -v t0", 6), ("stop -t beat", 6), ("start -t beat", 7),
                ("unload t3", 10), ("load t3 -t c:beat2", 0), ("start -v t3", 12),
                ("group g2 -v t0,t1 -t b:120", 0), ("start -g g2", 20),
                ("stop -g g2", 1), ("start -g g2", 33)]


def _graph_stat(name):
    from audio_decoder_tpu_torch.utils.trace import TRACE

    s = TRACE.stats.get(name)
    return (s.calls, s.items) if s is not None else (0, 0.0)


def _engine_loop(dev, graphed=True, seed=5):
    from audio_decoder_tpu_torch.runtime import loop as LM
    from audio_decoder_tpu_torch.runtime.native import Sink

    st, reg = engine_case(dev, seed=seed)
    loop = LM.EngineLoop(st, reg, 44100, 2, sink=Sink("default", 44100, 2, realtime=False))
    assert (loop._graphs is not None) == (dev.type == "cuda")
    if not graphed:
        loop._graphs = None  # the eager ops, as on every other device
    return loop


def _play(loop, script=GRAPH_SCRIPT):
    out = [loop.run_blocks(6, collect=True)]
    for line, n in script:
        assert loop.submit(line), (line, loop.errors)
        out.append(loop.run_blocks(n, collect=True))
    assert not loop.errors
    return np.concatenate(out)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_engine_loop_cuda_graphed_bit_identical_to_eager(cuda_device, monkeypatch):
    """The graphed loop against the eager loop on the card at SPEC_DEPTH 8
    over commands of every verb: every block and the end state bit for bit,
    every burst a replay, every depth of the ramp captured once."""
    from audio_decoder_tpu_torch.runtime import loop as LM

    monkeypatch.setattr(LM, "SPEC_DEPTH", 8)
    eager = _engine_loop(cuda_device, graphed=False)
    want = _play(eager)
    captures, replays = _graph_stat("engine.graph_capture"), _graph_stat("engine.graph_replay")
    bursts = _graph_stat("engine.burst")
    graphed = _engine_loop(cuda_device)
    got = _play(graphed)
    assert np.abs(want).max() > 0 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    for name in ("v_active", "v_pos", "clock"):
        assert _same_bits(getattr(graphed.state, name), getattr(eager.state, name)), name
    assert sorted(k[0] for k in graphed._graphs._graphs) == [1, 2, 4, 8]
    assert _graph_stat("engine.graph_capture")[0] - captures[0] == 4
    rendered = _graph_stat("engine.burst")[1] - bursts[1]
    assert _graph_stat("engine.graph_replay")[1] - replays[1] == rendered > len(want) // 128


def test_engine_loop_cuda_states_keep_their_values_after_later_replays(cuda_device, monkeypatch):
    """A state the graphed loop hands out (committed or speculated) aliases
    nothing a later replay rewrites: it keeps its values over bursts of
    every depth."""
    from audio_decoder_tpu_torch.engine import graphed as G
    from audio_decoder_tpu_torch.runtime import loop as LM

    monkeypatch.setattr(LM, "SPEC_DEPTH", 8)
    loop = _engine_loop(cuda_device)
    kept = []

    def keep():
        for st in [loop.state] + [tail for _, tail in loop._spec]:
            kept.append((st, {n: getattr(st, n).clone() for n in G.COPIED + G.IN_PLACE}))

    for n in (1, 2, 4, 9, 20):        # ends inside bursts of 1, 2, 4 and 8
        loop.run_blocks(n)
        keep()
    assert loop.submit("velocity t2 0.6")
    loop.run_blocks(40)
    assert loop.submit("stop -v t0")
    loop.run_blocks(3)
    assert not loop.errors and len(kept) > 10
    for st, values in kept:
        for name, value in values.items():
            assert _same_bits(getattr(st, name), value), name


def test_engine_loop_cuda_commands_between_bursts_capture_nothing(cuda_device, monkeypatch):
    from audio_decoder_tpu_torch.runtime import loop as LM

    monkeypatch.setattr(LM, "SPEC_DEPTH", 8)
    loop = _engine_loop(cuda_device)
    loop.run_blocks(15)               # bursts 1, 2, 4, 8: every depth captured
    captures, replays = _graph_stat("engine.graph_capture"), _graph_stat("engine.graph_replay")
    _play(loop)
    assert _graph_stat("engine.graph_capture") == captures
    assert _graph_stat("engine.graph_replay")[0] - replays[0] > len(GRAPH_SCRIPT)


def test_graphed_chain_cuda_captures_anew_for_another_store(cuda_device):
    """A state over another ``tracks`` tensor (other samples) gets its own
    graph, which renders that store: equal to the eager chain bit for bit."""
    from audio_decoder_tpu_torch.engine import graphed as G
    from audio_decoder_tpu_torch.engine import render as ER

    st, _ = engine_case(cuda_device, seed=6)
    chain = G.GraphedChain()
    captures = _graph_stat("engine.graph_capture")[0]
    first = chain.get(st, frames=128, out_channels=2, depth=4)
    moved = dataclasses.replace(st, v_pos=st.v_pos + 3.0)
    assert chain.get(moved, frames=128, out_channels=2, depth=4) is first
    for s in (st, moved):
        got = first(s)
        want = ER.render_chain(s, frames=128, out_channels=2, depth=4)
        assert all(_same_bits(a, b) for a, b in zip(got, want))
    other = dataclasses.replace(st, tracks=st.tracks.flip(0).contiguous() * 0.5)
    second = chain.get(other, frames=128, out_channels=2, depth=4)
    assert second is not first
    assert _graph_stat("engine.graph_capture")[0] - captures == 2
    got = second(other)
    want = ER.render_chain(other, frames=128, out_channels=2, depth=4)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert not _same_bits(got[0], first(st)[0])


def test_cli_render_cuda_within_one_lsb_of_cpu(cuda_device, tmp_path):
    from audio_decoder_tpu_torch import cli

    rng = np.random.default_rng(3)
    d = tmp_path / "assets"
    d.mkdir()
    for i in range(3):
        pcm = (rng.standard_normal((22050, 2)) * 6000).astype(np.int16)
        data = pcm.tobytes()
        fmt = struct.pack("<HHIIHH", 1, 2, 44100, 44100 * 4, 4, 16)
        body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(data)) + data)
        (d / f"w{i}.wav").write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    (d / "m.mp3").write_bytes(open(FIXTURES[1], "rb").read())
    script = tmp_path / "s.txt"
    script.write_text("load w0 -t s:300\nload w1\nload m\n"
                      "seq w0 -p 4 -s 0,2 -c a:0.7 -j a:0.3\ntrem w1 -t s:200 -p 2 -d 0.5\n"
                      "group g -v w1,m -t m:40\nstart -v w0\nstart -g g\n@0.2\n"
                      "velocity m -1.1\n@0.1\npause -g g\n@0.05\nresume -g g\n")
    outs = {}
    for plat in ("cuda", "cpu"):
        args = cli.parse_args((["--platform", "cpu"] if plat == "cpu" else [])
                              + ["render", "--assets", str(d), "--script",
                                 str(script), "--resample", "--seconds", "0.05",
                                 "--out", str(tmp_path / f"{plat}.wav")])
        assert args.platform == plat  # the card is the default
        assert args.fn(args) == 0
        outs[plat] = args.pcm.astype(np.int32)
        got = decode_paths([str(tmp_path / f"{plat}.wav")], device=plat).file(0)
        np.testing.assert_array_equal(got.pcm, args.pcm / np.float32(32768))
    assert outs["cuda"].shape == outs["cpu"].shape
    assert np.abs(outs["cuda"] - outs["cpu"]).max() <= 1


# ----------------------------------------- the mesh: K5 and the sharded decodes


def _logical_mesh(dev, n=4, model=1):
    """``n`` logical shards on one card (data n // model x model)."""
    from audio_decoder_tpu_torch.parallel import make_mesh

    return make_mesh(n, model, devices=[dev] * n)


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
def test_window_add_spmd_on_a_logical_mesh_matches_plain(cuda_device, dtype):
    """K5 over 4 data shards of one card (the last shard holds padding
    lanes only): one launch of its kernel over the 4 shards, no K3 launch,
    one psum that adds nothing and crosses no card; equal to the plain
    twins."""
    from audio_decoder_tpu_torch.parallel import mesh as M

    starts, upd, n_out = window_case(np.random.default_rng(31), 256, 520, 150,
                                     dtype=dtype)
    s, u = _on(cuda_device, starts, upd)
    before, coll = dict(PW.launches), dict(M.collectives)
    mesh = _logical_mesh(cuda_device)
    got = PW.window_add_spmd(s, u, n_out, mesh=mesh)
    torch.cuda.synchronize()
    assert {k: PW.launches[k] - before[k] for k in before} == {
        "window_add": 0, "window_add2": 0, "window_add_spmd": 1,
        "window_add_spmd_kernel": 1}
    assert (M.collectives["psum"] - coll["psum"],
            M.collectives["psum_nccl"] - coll["psum_nccl"]) == (1, 0)
    assert got.value.device.type == "cuda"
    assert torch.equal(got.value, PW.window_add_plain(s, u, n_out))
    assert torch.equal(got.value, PW.window_add_spmd_plain(
        s.chunk(4), u.chunk(4), n_out))


#: K5's edges whose shards differ in length: no views of one buffer
SPMD_UNEVEN = ("uneven-shards-i32", "overlap-i32")


def spmd_layout(sets, layout: str):
    """The shards as separate allocations, or as views of one buffer."""
    if layout == "separate":
        return sets
    starts = torch.cat([s for s, _ in sets])
    upd = torch.cat([u for _, u in sets])
    c = sets[0][0].shape[0]
    return [(starts[i * c:(i + 1) * c], upd[i * c:(i + 1) * c])
            for i in range(len(sets))]


@pytest.mark.parametrize("cid,layout", [
    (cid, lay) for cid in SPMD_CASES for lay in ("separate", "views")
    if lay == "separate" or cid not in SPMD_UNEVEN])
def test_window_add_spmd_kernel_edges(cuda_device, cid, layout):
    """K5 on its own edges (``spmd_case``), each shard a data shard of a
    logical mesh of the card, held to ``window_add_spmd_plain`` with
    ``torch.equal``: int32 on any input, float32 with one nonzero term per
    element; one kernel launch and no K3 launch per call; called twice,
    the same bits."""
    from audio_decoder_tpu_torch import parallel as P

    shards, n_out = spmd_case(cid)
    sets = spmd_layout([tuple(_on(cuda_device, st, u)) for st, u in shards],
                       layout)
    if layout == "views":
        assert len({u.untyped_storage().data_ptr() for _, u in sets}) == 1
    mesh = _logical_mesh(cuda_device, len(sets))
    S, U = P.Sharded(tuple(st for st, _ in sets)), P.Sharded(tuple(u for _, u in sets))
    before = dict(PW.launches)
    got = PW.window_add_spmd(S, U, n_out, mesh=mesh).value
    again = PW.window_add_spmd(S, U, n_out, mesh=mesh).value
    ref = PW.window_add_spmd_plain(S.shards, U.shards, n_out)
    torch.cuda.synchronize()
    assert PW.launches["window_add_spmd_kernel"] - before["window_add_spmd_kernel"] == 2
    assert PW.launches["window_add"] == before["window_add"]
    assert got.dtype == ref.dtype and got.shape == (n_out,)
    assert torch.equal(got, ref)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_window_add_spmd_kernel_on_unaligned_shards(cuda_device):
    """A shard whose updates begin one element into their storage (the
    4-byte path) beside 16-byte aligned ones, in one launch."""
    shards, n_out = spmd_case("pile-up-middle-f32")
    sets = [tuple(_on(cuda_device, st, u)) for st, u in shards]
    sets[1] = (sets[1][0], unaligned_view(sets[1][1]))
    assert sets[1][1].data_ptr() % 16 != 0
    got = PW._window_add_spmd_cuda(sets, n_out)
    ref = PW.window_add_spmd_plain(*zip(*sets), n_out)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_sharded_wav_decode_on_a_logical_mesh_equals_one_card(cuda_device):
    from audio_decoder_tpu_torch.dsp.consensus import consensus_config
    from audio_decoder_tpu_torch.io.assets import pack_bytes
    from audio_decoder_tpu_torch.parallel import (decode_pcm_step, pad_batch,
                                                  sharded_decode_fn)
    from audio_decoder_tpu_torch.parallel.dryrun import wav_blob

    rng = np.random.default_rng(32)
    pcm = [rng.integers(-32768, 32768, (4000 + 7 * i, 2)).astype(np.int16)
           for i in range(5)]
    bufs, lens, valid = pad_batch(*pack_bytes([wav_blob(p, 44100) for p in pcm]), 4)
    kw = dict(bits=16, channels=2, max_frames=4096)
    out, meta, rate, ch = sharded_decode_fn(_logical_mesh(cuda_device, 8, 2),
                                            **kw)(bufs, lens)
    one, one_meta = decode_pcm_step(*_on(cuda_device, bufs, lens), **kw)
    assert out.shards[0].device.type == "cuda"
    assert torch.equal(out.gather(), one)
    for k in one_meta:
        assert torch.equal(meta[k].gather(), one_meta[k]), k
    want = consensus_config(one_meta["sample_rate"], one_meta["channels"],
                            one_meta["err"])
    assert (int(rate.value), int(ch.value)) == tuple(int(x) for x in want)
    assert (one_meta["err"].cpu().numpy()[~valid] != 0).all()


def test_sharded_flac_decode_on_a_logical_mesh_equals_one_card(cuda_device):
    """The music fixture twice and 6 seeded files of distinct content, over
    4 data shards: K5 3 times, one kernel launch each (one card), K3 and K4
    never; equal to the single-card decode bit for bit."""
    from audio_decoder_tpu_torch.parallel import round_sizing, sharded_flac_fn

    from . import flac_writer

    rng = np.random.default_rng(33)
    blobs = [open(FLAC_FIXTURES[0], "rb").read()] * 2 + [
        flac_writer.encode_file(rng.integers(-9000, 9000, (3000 + 311 * i, 2)),
                                blocksize=1024) for i in range(6)]
    analyses = [FF.analyze(b) for b in blobs]
    sizing = round_sizing(FD.sizing_for(analyses), 4)
    args, statics = FD.pack_group(analyses, cuda_device, sizing)
    before = dict(PW.launches)
    pcm, ovf = sharded_flac_fn(_logical_mesh(cuda_device), **statics)(*args)
    torch.cuda.synchronize()
    got = {k: PW.launches[k] - before[k] for k in before}
    assert got == {"window_add": 0, "window_add2": 0, "window_add_spmd": 3,
                   "window_add_spmd_kernel": 3}
    one, one_ovf = FV.flac_decode_batch(*args, **statics)
    assert torch.equal(pcm.gather(), one)
    assert torch.equal(ovf.gather(), one_ovf) and not bool(one_ovf.any())


def test_dryrun_multichip_on_a_logical_mesh(cuda_device):
    """The multi-device dry run on 8 logical shards of one card: every path
    runs (WAV, MP3, Layer II, FLAC, the render) and holds against one
    card; K5 launches its own kernel once per call (one card), never K3."""
    from audio_decoder_tpu_torch.codecs.mpeg import frontend as MF
    from audio_decoder_tpu_torch.parallel import dryrun_multichip

    from . import flac_writer, seeded_writers

    rng = np.random.default_rng(34)
    mp3 = open(FIXTURES[0], "rb").read()
    inputs = {"mp3": mp3[:MF.find_frames(mp3)[12][0]],
              "layer2": seeded_writers.layer2_frames(rng, 3, 2),
              "flac": flac_writer.encode_file(rng.integers(-3000, 3000, (900, 2)),
                                              blocksize=256)}
    out = dryrun_multichip(8, devices=[cuda_device] * 8, inputs=inputs)
    assert out["mesh"] == {"data": 4, "model": 2}
    assert out["paths"] == ["wav", "mp3", "layer2", "flac", "render"]
    n = out["launches"]
    # the sharded FLAC decode: 3 K5 calls, one kernel launch each; the
    # single card's: K4 once, K3 once
    assert (n["window_add_spmd"], n["window_add_spmd_kernel"], n["window_add"],
            n["window_add2"]) == (3, 3, 1, 1)
    assert n["mp3_entropy_scan"] > 0 and n["mp3_polyphase_synthesis"] > 0
    assert n["collective_psum_nccl"] == 0


# ---------------------------------------------------------------------------
# The FLAC encoder's two device passes on the card
# ---------------------------------------------------------------------------

#: the encoder's bar for its f32 sums (cost, autocorrelation, psums)
ENCODE_TOL = 1e-6


def flac_music(rng, S, C=2, rate=44100):
    """Correlated tonal material with a little noise, as f32 on the 16-bit
    grid (the content LPC analysis is for)."""
    t = np.arange(S) / rate
    m = sum(a * np.sin(2 * np.pi * f * t + 0.1 * np.sin(2 * np.pi * 3 * t))
            for f, a in ((82.4, 0.3), (164.8, 0.22), (329.6, 0.18),
                         (659.3, 0.08), (1318.5, 0.04)))
    m = m * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t))
    m = m + 0.004 * rng.standard_normal(S)
    x = np.stack([np.roll(m, 7 * c) * (1.0 - 0.1 * c) for c in range(C)], 1)
    return (np.round(x * 2.0 ** 15 * 0.6) / 2.0 ** 15).astype(np.float32)


def flac_blocked(x, blocksize):
    """encode_flac's frame blocking: [Fb, blocksize, C] f32 and nvalid [Fb]
    i32 (Fb the power-of-two bucket of the frame count)."""
    S, C = x.shape
    F = -(-S // blocksize)
    Fb = max(1, 1 << (F - 1).bit_length())
    xb = np.pad(x, ((0, Fb * blocksize - S), (0, 0))).reshape(Fb, blocksize, C)
    nvalid = np.clip(S - np.arange(Fb) * blocksize, 0, blocksize)
    return xb, nvalid.astype(np.int32)


def fixed_costs64(cands, nvalid, cbps):
    """Pass A's FIXED cost model per order in f64: [5, F, NC]."""
    _F, _NC, nmax = cands.shape
    cbps = np.asarray(cbps, np.float64)
    idx = np.arange(nmax)
    valid = idx[None, :] < nvalid[:, None]
    r = cands.astype(np.int64)
    ks = np.arange(31, dtype=np.float64)[:, None, None]
    out = []
    for o in range(5):
        m = valid[:, None, :] & (idx >= o)[None, None, :]
        s = np.where(m, (r << 1) ^ (r >> 63), 0).sum(-1).astype(np.float64)
        cnt = m.sum(-1).astype(np.float64)
        out.append((s[None] * 2.0 ** -ks + cnt[None] * (ks + 1)).min(0)
                   + o * cbps[None, :])
        r = r - np.pad(r, ((0, 0), (0, 0), (1, 0)))[:, :, :nmax]
    return np.stack(out)


def check_pass_a(want, got, nvalid, bits, channels) -> dict:
    """Pass A's bar (numpy dicts): ``ints``, ``cands`` and ``is_const``
    exact; ``fixed_cost`` within 1e-6 relative; ``fixed_order`` exact but on
    frames whose two orders' costs (in f64) tie within 1e-6; ``acorr``
    within 1e-6 of its lag 0.  Returns the flipped orders and the largest
    relative differences."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    for k in ("ints", "cands", "is_const"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    wc = want["fixed_cost"].astype(np.float64)
    cost_rel = np.abs(got["fixed_cost"] - wc) / np.maximum(np.abs(wc), 1.0)
    assert cost_rel.max() <= ENCODE_TOL, cost_rel.max()
    flip = got["fixed_order"] != want["fixed_order"]
    if flip.any():
        NC = want["cands"].shape[1]
        cbps = [bits, bits, bits + 1, bits] if channels == 2 else [bits] * NC
        c64 = fixed_costs64(want["cands"], nvalid, cbps)
        f, c = np.nonzero(flip)
        a = c64[want["fixed_order"][f, c], f, c]
        b = c64[got["fixed_order"][f, c], f, c]
        assert np.all(np.abs(a - b) <= ENCODE_TOL * np.abs(a)), (a, b)
    lag0 = want["acorr"][..., :1].astype(np.float64)
    diff = np.abs(got["acorr"] - want["acorr"].astype(np.float64))
    assert np.all(diff <= ENCODE_TOL * lag0)
    acorr_rel = float((diff / np.where(lag0 > 0, lag0, 1.0)).max())
    return dict(flipped=int(flip.sum()), cost_rel=float(cost_rel.max()),
                acorr_rel=acorr_rel)


def check_pass_b(want, got) -> float:
    """Pass B's bar (numpy dicts): ``sub`` and ``resid`` exact, ``psums``
    within 1e-6 relative.  Returns the largest relative ``psums`` difference."""
    for k in ("sub", "resid"):
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["psums"].dtype == np.float32
    w = want["psums"].astype(np.float64)
    rel = np.abs(got["psums"] - w) / np.maximum(w, 1.0)
    assert rel.max() <= ENCODE_TOL, rel.max()
    return float(rel.max())


def flac_passes(x, dev, *, bits=16, blocksize=4096, level=5, dither=None,
                plan_from=None):
    """The port's pass A on ``dev``, the planner on pass A's output (or on
    ``plan_from``'s, another run's pass A), and pass B on ``dev`` with that
    plan: (pass A as numpy, the plan, pass B as numpy, nvalid)."""
    from audio_decoder_tpu_torch.codecs.flac import encode as PX

    C = x.shape[1]
    maxo, names = PX.LEVELS[level]
    xb, nvalid = flac_blocked(x, blocksize)
    w = (torch.as_tensor(PX.window_bank(names, blocksize), device=dev)
         if maxo else None)
    nv = torch.as_tensor(nvalid, device=dev)
    out = PX.flac_cost_batch(torch.as_tensor(xb, device=dev), nv, w, bits=bits,
                             channels=C, nmax=blocksize, maxo=maxo, dither=dither)
    a = {k: v.cpu().numpy() for k, v in out.items()}
    plan = PX._plan_predictors(a if plan_from is None else plan_from,
                               nvalid.astype(np.int64), bits=bits, channels=C,
                               maxo=maxo, nmax=blocksize)
    _mode, sel, _kind, order, shift, coeffs, _prec = plan
    res = PX.flac_residual_batch(
        out["cands"], nv, *(torch.as_tensor(v, device=dev)
                            for v in (sel, order, coeffs, shift)),
        channels=C, nmax=blocksize, npart=PX._npart(blocksize),
        maxo=max(maxo, 4))
    return a, plan, {k: v.cpu().numpy() for k, v in res.items()}, nvalid


@pytest.mark.parametrize("level,bits,C,dither", [(5, 16, 2, None),
                                                 (8, 16, 2, None),
                                                 (0, 24, 1, 7), (8, 24, 6, None)])
def test_flac_encode_passes_cuda_match_cpu(cuda_device, level, bits, C, dither):
    """Pass A on the card against the CPU at the encoder's bar, then pass B
    on both with the CPU's plan."""
    x = flac_music(np.random.default_rng(level + C), 44100 * 2, C)
    cpu_a, _plan, cpu_b, nvalid = flac_passes(x, "cpu", bits=bits, level=level,
                                              dither=dither)
    gpu_a, _plan, gpu_b, _ = flac_passes(x, cuda_device, bits=bits, level=level,
                                         dither=dither, plan_from=cpu_a)
    check_pass_a(cpu_a, gpu_a, nvalid, bits, C)
    check_pass_b(cpu_b, gpu_b)


def test_write_audio_flac_round_trip_on_the_card(cuda_device, tmp_path):
    """``write_audio`` to .flac on the card decodes on the card to the
    quantized input bit for bit, with its STREAMINFO MD5."""
    from audio_decoder_tpu_torch import write_audio

    x = flac_music(np.random.default_rng(5), 30000)
    path = tmp_path / "x.flac"
    write_audio(str(path), x, 44100, device=cuda_device)
    f = decode_paths([str(path)], device=cuda_device).file(0)
    assert f.err == 0
    ints = np.round(f.pcm.astype(np.float64) * 2.0 ** 15).astype(np.int64)
    np.testing.assert_array_equal(ints, np.round(x * 2.0 ** 15).astype(np.int64))
    assert FF.verify_md5(FF.analyze(path.read_bytes()), ints) is True


def test_threefry_range_and_normal_on_the_card(cuda_device):
    """``uniform`` over a range equals the CPU's bit for bit on the card;
    ``normal`` within 2e-6 (the card's ``log1p`` rounds as CUDA's does)."""
    from audio_decoder_tpu_torch.utils import threefry as TF

    for lo, hi in ((1000.0, 87200.0), (-3.0, 5.5), (0.0, 1.0)):
        cpu = TF.uniform(TF.prng_key(12, device="cpu"), (100_000,), lo, hi)
        gpu = TF.uniform(TF.prng_key(12, device=cuda_device), (100_000,), lo, hi)
        assert torch.equal(gpu.cpu(), cpu)
    cpu = TF.normal(TF.prng_key(11, device="cpu"), (8, 4410, 2))
    gpu = TF.normal(TF.prng_key(11, device=cuda_device), (8, 4410, 2))
    assert float((gpu.cpu() - cpu).abs().max()) <= 2e-6
