"""The input makers and the writers: a pool depends on its configuration
alone and is kept by the pool cache, the FLAC writer's streams decode
through the reference to their source, and the MP3 writer's streams decode
through the reference to about their source."""

import numpy as np
import pytest

from h100bench import pool
from h100bench.inputs import flac_writer, mp3_writer, music_mp3, speech_flac
from h100bench.reference import flac, mp3
from h100bench.run import cell_parts, load_benchmark
from h100bench.tests.conftest import small

BENCH = load_benchmark()


def _config(cell):
    return {**cell_parts(BENCH, cell)[1], **small(cell)[0]}


def test_the_speech_lengths_keep_the_corpus_mean_and_cap():
    cfg = cell_parts(BENCH, "librispeech-flac.loader")[1]
    n = speech_flac.lengths(cfg) / cfg["sample_rate"]
    assert len(n) == cfg["pool_files"] == len(set(np.round(n, 3))) + np.sum(n == n.max()) - 1
    assert abs(n.mean() - cfg["mean_length_s"]) < 0.05
    assert n.min() >= cfg["min_length_s"] and n.max() <= cfg["max_length_s"]
    assert np.array_equal(speech_flac.lengths(cfg), speech_flac.lengths(dict(cfg)))


@pytest.mark.parametrize("cell", ["fma-mp3.loader", "librispeech-flac.loader"])
def test_a_pool_depends_on_its_configuration_alone_and_is_kept(cell, tmp_path):
    cfg = _config(cell)
    a, made_a = pool.load(cfg, str(tmp_path), 1)
    b, made_b = pool.load(cfg, str(tmp_path), 1)
    assert made_a and not made_b and a.blobs == b.blobs and a.info == b.info
    assert len(set(a.blobs)) == len(a.blobs) == cfg["pool_files"]
    c, made_c = pool.load({**cfg, "pool_seed": cfg["pool_seed"] + 1}, str(tmp_path), 1)
    assert made_c and set(c.blobs).isdisjoint(a.blobs)


def test_the_speech_pool_encodes_its_truth():
    cfg = _config("librispeech-flac.loader")
    files = speech_flac.make_files(cfg, [0, 3])
    for (blob, info), i in zip(files, [0, 3]):
        src = speech_flac.truth(cfg, i)
        assert info["frames"] == len(src) and np.array_equal(flac.decode_many([blob])[0], src)


def test_the_music_clips_are_the_configured_bitrates_and_frames():
    cfg = {**_config("fma-mp3.loader"), "clip_seconds": 2.0}
    for i, (blob, info) in enumerate(music_mp3.make_files(cfg, [0, 1, 2, 3])):
        frames = mp3.find_frames(blob)
        assert [p for p, _ in frames] == info["frame_offsets"]
        assert {h["bitrate"] for _, h in frames} == {cfg["bitrates_kbps"][i] * 1000}
        assert info["frames"] == len(frames) * 1152 == 77 * 1152
        assert {h["mode"] for _, h in frames} == {1}


def test_the_mp3_writer_round_trips_through_the_reference():
    rng = np.random.default_rng(3)
    n = 44100
    pcm = music_mp3.music(rng, n, 44100)
    for kbps, snr_db in ((320, 25.0), (128, 12.0)):
        blob, offsets = mp3_writer.encode(pcm, kbps)
        out, sr = mp3.decode(blob)
        assert sr == 44100 and out.shape == (len(offsets) * 1152, 2)
        # the filterbanks delay the signal by 1,057 samples (481 + 576)
        got, want = out[1057:1057 + n - 2000], pcm[:n - 2000]
        err = np.sum((got - want) ** 2) / np.sum(want ** 2)
        assert -10 * np.log10(err) > snr_db
        # a frame's bits fill it: the coded bits are most of the bitrate's
        _, coded = mp3.huffman_bits(blob)
        assert coded > 0.8 * kbps * 1000 * len(offsets) * 1152 / 44100


def test_the_mp3_writer_refuses_a_bitrate_layer_iii_lacks():
    with pytest.raises(ValueError):
        mp3_writer.encode(np.zeros((1152, 2)), 300)


def _streams():
    rng = np.random.default_rng(5)
    t = np.arange(40000)
    tone = 3000 * np.sin(2 * np.pi * 200 * t / 16000) + 30 * rng.standard_normal(40000)
    return [
        np.clip(np.round(tone), -32768, 32767).astype(np.int16),   # LPC and FIXED
        np.zeros(9000, np.int16),                                   # CONSTANT
        rng.integers(-32768, 32768, 7000).astype(np.int16),         # VERBATIM
        np.array([5], np.int16), np.arange(4097).astype(np.int16),  # short last frames
        speech_flac.speech(rng, 20000, 16000),
    ]


def test_the_writers_streams_decode_through_the_reference_to_their_source():
    src = _streams()
    blobs = flac_writer.encode_many(src, 16000)
    for s, d in zip(src, flac.decode_many(blobs)):
        assert d.shape == (len(s), 1) and np.array_equal(d[:, 0], s)


def test_the_writer_emits_what_the_format_defines():
    blob = flac_writer.encode_many([np.arange(5000).astype(np.int16)], 16000)[0]
    assert blob[:4] == b"fLaC" and blob[4] == 0x80 and blob[42:44] == b"\xff\xf8"
    # STREAMINFO: blocksize 4096, 16 kHz, mono, 16-bit, 5,000 samples
    w = int.from_bytes(blob[18:26], "big")
    assert int.from_bytes(blob[8:10], "big") == 4096
    assert (w >> 44, (w >> 41) & 7, (w >> 36) & 31, w & ((1 << 36) - 1)) == (16000, 0, 15, 5000)
    info, frames = flac._walk(blob)
    assert info["total"] == 5000 and len(frames) == 2


@pytest.mark.parametrize("k", [0, 1])
def test_the_frame_crcs_hold(k):
    src = _streams()[k]
    blob = flac_writer.encode_many([src], 16000)[0]
    pos, ends = 42, []
    while pos < len(blob):
        nxt = blob.find(b"\xff\xf8", pos + 2)
        nxt = len(blob) if nxt < 0 else nxt
        ends.append((pos, nxt))
        pos = nxt
    for a, b in ends:
        frame = blob[a:b]
        hlen = 4 + 1 + (2 if frame[2] >> 4 == 7 else 0)
        if frame[4] >= 0x80:
            hlen += 1
        assert flac_writer.crc8(frame[:hlen]) == frame[hlen]
        r = 0
        for byte in frame[:-2]:
            r = ((r << 8) & 0xFFFF) ^ int(flac_writer.CRC16[(r >> 8) ^ byte])
        assert r == int.from_bytes(frame[-2:], "big")
