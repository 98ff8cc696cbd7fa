"""The port's storage backends held to the JAX package's: the cases of
tests/test_storage_backends.py (files, packed, audio, captions) run on the
port with ``Client(device="cpu")``, and a stream written by one package
is read by the other with equal bytes. ``decode_wav`` arrays and
``parse_srt`` records are equal across the two; the compressed-audio
cases need the port's libav module (``io/av.available()``) and skip where
it cannot be built, as the JAX package's do.
"""

import json
import struct
import wave

import numpy as np
import pytest

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.storage import audio as jaudio
from scannertools_tpu.storage import captions as jcaptions
from scannertools_tpu_torch import types as st_types
from scannertools_tpu_torch.io import av as pav
from scannertools_tpu_torch.storage import audio as paudio
from scannertools_tpu_torch.storage import captions as pcaptions
from scannertools_tpu_torch.storage.packed_format import write_packed
from test_torch_jax_decoder import jax_native_decoder


@pytest.fixture()
def psc(tmp_path):
    return st.Client(db_path=str(tmp_path / "pdb"), device="cpu")


@pytest.fixture()
def jsc(tmp_path):
    return jst.Client(db_path=str(tmp_path / "jdb"))


def _pass(sc, pkg, src, dst, **perf):
    node = sc.ops.Pass(elements=sc.io.Input([src]))
    sc.run(sc.io.Output(node, [dst]), pkg.PerfParams.manual(**perf)
           if perf else pkg.PerfParams.estimate(),
           cache_mode=pkg.CacheMode.Overwrite)


# ---------------------------------------------------------------- files


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_roundtrip_cross_read(psc, jsc, tmp_path, writer):
    """files source -> Pass -> files sink (tests/test_all.py:64-118) in
    one package; the other reads the sink's files back, equal bytes."""
    in_paths, out_paths = [], []
    for i in range(4):
        p = str(tmp_path / f"in_{i}.bin")
        with open(p, "wb") as f:
            f.write(struct.pack("=Q", i))
        in_paths.append(p)
        out_paths.append(str(tmp_path / f"out_{i}.bin"))
    sc, pkg, reader = (psc, st, jst) if writer == "port" else (jsc, jst, st)
    outs = pkg.FilesStream(out_paths)
    _pass(sc, pkg, pkg.FilesStream(in_paths), outs)
    assert outs.committed()
    for i, p in enumerate(out_paths):
        (v,) = struct.unpack("=Q", open(p, "rb").read())
        assert v == i
    back = reader.FilesStream(out_paths)
    assert back.committed() and len(back) == 4
    assert list(back.load_bytes()) == [struct.pack("=Q", i)
                                       for i in range(4)]
    assert list(back.load_bytes([3, 1])) == list(outs.load_bytes([3, 1]))


# ---------------------------------------------------------------- packed


def test_packed_file_stream(psc, jsc, tmp_path):
    """PackedFileStream as source and sink in each package: equal files,
    each read by the other."""
    p = str(tmp_path / "x.pack")
    write_packed(p, [b"a", b"bb", b"ccc"])
    stream = st.PackedFileStream(p)
    assert len(stream) == 3
    assert list(stream.load_bytes([2, 0])) == [b"ccc", b"a"]
    out = st.PackedFileStream(str(tmp_path / "y.pack"))
    _pass(psc, st, stream, out)
    jout = jst.PackedFileStream(str(tmp_path / "z.pack"))
    _pass(jsc, jst, jst.PackedFileStream(p), jout)
    assert list(out.load_bytes()) == [b"a", b"bb", b"ccc"]
    assert open(tmp_path / "y.pack", "rb").read() == \
        open(tmp_path / "z.pack", "rb").read()
    assert list(jst.PackedFileStream(str(tmp_path / "y.pack"))
                .load_bytes()) == list(st.PackedFileStream(
                    str(tmp_path / "z.pack")).load_bytes())
    assert out.committed() and out.storage() is not None
    out.delete()
    assert not out.exists()


def test_packed_typed_rows_from_an_op(psc, jsc, tmp_path, test_video):
    """Histogram rows sunk to a PackedFileStream by each package: equal
    files, and the typed rows read back equal the NamedStream's."""
    paths = {}
    for name, sc, pkg, kw in (("port", psc, st, {"ingest": "rgb"}),
                              ("jax", jsc, jst, {"ingest": "rgb"})):
        video = pkg.NamedVideoStream(sc, "v", path=test_video["path"])
        frame = sc.streams.Range(sc.io.Input([video]), [(0, 40)])
        hist = sc.ops.Histogram(frame=frame)
        paths[name] = str(tmp_path / f"{name}.pack")
        named = pkg.NamedStream(sc, "hist")
        sc.run(sc.io.Output([hist, hist], [(pkg.PackedFileStream(
            paths[name]), named)]), pkg.PerfParams.manual(
                work_packet_size=16, **kw),
            cache_mode=pkg.CacheMode.Overwrite)
        if name == "port":
            parse = st_types.get_type(named.type_name()).parse
            rows = [parse(b) for b in st.PackedFileStream(
                paths[name]).load_bytes()]
            want = list(named.load())
            assert len(rows) == 40
            assert all(np.array_equal(np.stack(a), np.stack(b))
                       for a, b in zip(rows, want))
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()


# ---------------------------------------------------------------- audio


def _write_wav(path, rate=8000, dur=3.7, width=2):
    t = np.arange(int(rate * dur)) / rate
    sig = 0.5 * np.sin(2 * np.pi * 440 * t)
    data = {1: ((sig * 127) + 128).astype(np.uint8),
            2: (sig * 32767).astype(np.int16),
            4: (sig * 2 ** 31 * 0.9).astype(np.int32)}[width]
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())
    return data


def test_audio_stream(psc, tmp_path):
    """wav -> fixed frame_size f32 frames, zero-filled at EOF
    (audio_source.cpp:104-210 semantics), through Discard."""
    wav_path = str(tmp_path / "a.wav")
    sig = _write_wav(wav_path)
    stream = st.AudioStream(wav_path, frame_size=1.0)
    assert len(stream) == 3
    frames = list(stream.load())
    assert all(f.shape == (8000,) and f.dtype == np.float32 for f in frames)
    want = sig[8000:16000].astype(np.float32) / 32768.0
    assert np.allclose(frames[1], want, atol=1e-6)
    node = psc.ops.Discard(elements=psc.io.Input([stream]))
    out = st.NamedStream(psc, "audio_discard")
    psc.run(psc.io.Output(node, [out]), st.PerfParams.estimate(),
            cache_mode=st.CacheMode.Overwrite)
    assert len(out) == 3


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("frame_size", [1.0, 0.35])
def test_audio_wav_equals_jax(tmp_path, width, frame_size):
    """decode_wav arrays and every AudioStream element equal the JAX
    package's, whole and by sparse rows (the EOF window zero-filled)."""
    path = str(tmp_path / f"w{width}.wav")
    _write_wav(path, rate=11025, dur=2.3, width=width)
    (ps, pr), (js, jr) = paudio.decode_wav(path), jaudio.decode_wav(path)
    assert pr == jr and ps.dtype == js.dtype
    np.testing.assert_array_equal(ps, js)
    p = st.AudioStream(path, frame_size=frame_size)
    j = jst.AudioStream(path, frame_size=frame_size)
    assert len(p) == len(j) and p.sample_rate == j.sample_rate
    assert list(p.load_bytes()) == list(j.load_bytes())
    rows = [len(p) - 1, 0]
    assert list(p.load_bytes(rows)) == list(j.load_bytes(rows))


def test_audio_compressed_equals_jax(tmp_path):
    """A compressed (AAC) file, which decodes through libav in both
    packages: equal elements. Skips where the port's libav module cannot
    be built (the card's machine has no libav development files)."""
    if not pav.available():
        pytest.skip("the port's native libav module (st_av) is unavailable")
    jax_native_decoder()
    rate = 22050
    sig = (0.3 * np.sin(2 * np.pi * 220 * np.arange(int(rate * 2.5))
                        / rate)).astype(np.float32)
    path = str(tmp_path / "tone.m4a")
    pav.encode_audio(path, sig, rate)
    p = st.AudioStream(path, frame_size=1.0)
    j = jst.AudioStream(path, frame_size=1.0)
    assert len(p) == len(j) >= 2
    assert list(p.load_bytes()) == list(j.load_bytes())
    assert list(p.load_bytes([1])) == list(j.load_bytes([1]))


# ---------------------------------------------------------------- captions


SRT = """1
00:00:01,000 --> 00:00:04,000
Hello world

2
00:00:12,500 --> 00:00:15,000
Second caption
spanning two lines

3
00:01:00,000 --> 00:01:05,000
Third
"""


def test_caption_stream(tmp_path):
    """SRT windowing: floor(max_time/ws) elements; JSON per window keyed
    by caption start time (captions_source.cpp:153-155,214-237)."""
    p = str(tmp_path / "c.srt")
    with open(p, "w") as f:
        f.write(SRT)
    stream = st.CaptionStream(p, window_size=10.0, max_time=95.0)
    assert len(stream) == 9
    wins = [json.loads(b.decode()) for b in stream.load_bytes()]
    assert [c["line"] for c in wins[0]] == ["Hello world"]
    assert [c["line"] for c in wins[1]] == [
        "Second caption spanning two lines"]
    assert wins[2] == []
    assert [c["line"] for c in wins[6]] == ["Third"]
    assert wins[0][0]["start"] == 1.0 and wins[0][0]["end"] == 4.0


@pytest.mark.parametrize("window,max_time", [(10.0, 95.0), (2.5, 66.0),
                                             (30.0, 30.0)])
def test_captions_equal_jax(tmp_path, window, max_time):
    """parse_srt records and CaptionStream windows equal the JAX
    package's, byte for byte."""
    text = SRT + "\n4\n00:01:01.250 --> 00:01:02.000\n<i>Over</i>lap\n"
    assert [vars(c) for c in pcaptions.parse_srt(text)] == \
        [vars(c) for c in jcaptions.parse_srt(text)]
    p = str(tmp_path / "c.srt")
    with open(p, "w") as f:
        f.write(text)
    ps = st.CaptionStream(p, window_size=window, max_time=max_time)
    js = jst.CaptionStream(p, window_size=window, max_time=max_time)
    assert len(ps) == len(js)
    assert list(ps.load_bytes()) == list(js.load_bytes())
    assert list(ps.load_bytes([len(ps) - 1])) == \
        list(js.load_bytes([len(js) - 1]))


def test_package_exports():
    for name in ("AudioStorage", "AudioStream", "CaptionStorage",
                 "CaptionStream", "FilesStorage", "FilesStream",
                 "PackedFileStorage", "PackedFileStream"):
        assert name in st.__all__ and hasattr(st, name)
        assert type(getattr(st, name)).__name__ == \
            type(getattr(jst, name)).__name__
