"""The port's native IO library (``attention_based_tbn_tpu_torch/native``)
against the JAX package's ``libtbn_io.so`` and cv2. The port decodes JPEG
through its own baseline decoder (``native/jpeg_codec.cpp``), the JAX
library and cv2 through libjpeg.

The cases of ``tests/test_native.py``, each held bit for bit: JPEG decode
(RGB and gray) equal to the JAX library's and to cv2's; invalid data
raising; ``resize_bilinear`` and ``decode_batch`` equal to the JAX
library's; ``read_wav`` equal to the JAX library's at 24, 48, 44.1 and 16
kHz and in the stereo, short ``fmt``, odd junk chunk and truncated data
chunk cases; the ``tpu.native_io`` gate; a missing compiler raising. Then
the decoder against libjpeg over qualities, samplings, odd sizes and
restart intervals, the files it refuses, and the committed test data
(``native/testdata``: the files and the checksums that ``chip_smoke.py``
holds the card's build to) regenerated from its seed.
"""

import hashlib
import json
import os
import shutil
import wave

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from attention_based_tbn_tpu import native as jax_native  # noqa: E402
from attention_based_tbn_tpu_torch import native  # noqa: E402
from attention_based_tbn_tpu_torch.config import load_config  # noqa: E402
from attention_based_tbn_tpu_torch.data import audio, dataset  # noqa: E402

TESTDATA = os.path.join(os.path.dirname(native.__file__), "testdata")


@pytest.fixture(scope="module")
def jax_lib():
    if not jax_native.ensure_built():
        pytest.fail("the JAX package's native library does not build on this host")
    return jax_native


@pytest.fixture(scope="module")
def lib():
    return native.load()


@pytest.fixture(scope="module")
def jpeg_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("imgs") / "test.jpg"
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8), (15, 15), 5)
    cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(path)


def write_wav(path, samples, sr, channels=1):
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(channels)
        handle.setsampwidth(2)
        handle.setframerate(sr)
        handle.writeframes(pcm.tobytes())


def write_riff(path, chunks):
    """A RIFF/WAVE file from raw (id, payload) chunks, word-aligned."""
    body = b"WAVE"
    for cid, payload in chunks:
        body += cid + len(payload).to_bytes(4, "little") + payload
        if len(payload) & 1:
            body += b"\x00"
    with open(path, "wb") as handle:
        handle.write(b"RIFF" + len(body).to_bytes(4, "little") + body)


def pcm_fmt(sr, bits=16):
    return ((1).to_bytes(2, "little") + (1).to_bytes(2, "little") + sr.to_bytes(4, "little")
            + (2 * sr).to_bytes(4, "little") + (2).to_bytes(2, "little")
            + bits.to_bytes(2, "little"))


def tone(sr, seconds=2.0, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    noise = np.random.default_rng(seed).standard_normal(t.shape)
    return 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * noise


# ------------------------------------------------------------------ JPEG


def test_decode_matches_jax_and_cv2(lib, jax_lib, jpeg_file):
    ours = lib.decode_jpeg_file(jpeg_file)
    np.testing.assert_array_equal(ours, jax_lib.decode_jpeg_file(jpeg_file))
    np.testing.assert_array_equal(ours, cv2.imread(jpeg_file))  # BGR


def test_grayscale(lib, jax_lib, jpeg_file):
    ours = lib.decode_jpeg_file(jpeg_file, grayscale=True)
    assert ours.shape == (120, 160)
    np.testing.assert_array_equal(ours, jax_lib.decode_jpeg_file(jpeg_file, grayscale=True))
    np.testing.assert_array_equal(ours, cv2.imread(jpeg_file, 0))


def test_invalid_data(lib):
    with pytest.raises(IOError, match="invalid JPEG"):
        lib.decode_jpeg(b"not a jpeg")


def test_codec_names_what_it_refuses(lib):
    img = np.random.default_rng(1).integers(0, 255, (32, 48, 3), np.uint8)
    _, progressive = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(IOError, match="progressive"):
        lib.decode_jpeg(progressive.tobytes())
    baseline = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    sof = baseline.index(b"\xff\xc0")
    baseline[sof + 1] = 0xC9  # the same file declared arithmetic-coded
    with pytest.raises(IOError, match="arithmetic"):
        lib.decode_jpeg(bytes(baseline))


def dht_tables(data):
    """(offset of the class/id byte, class, id, symbol count) of every
    Huffman table in a JPEG's DHT segments."""
    tables, at = [], 2
    while data[at + 1] != 0xDA:
        length = int.from_bytes(data[at + 2:at + 4], "big")
        if data[at + 1] == 0xC4:
            p = at + 4
            while p < at + 2 + length:
                count = sum(data[p + 1:p + 17])
                tables.append((p, data[p] >> 4, data[p] & 15, count))
                p += 17 + count
        at += 2 + length
    return tables


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("symbol", [12, 15, 16, 255])
def test_dc_magnitude_above_15_refused_as_libjpeg(lib, jax_lib, gray, symbol):
    """A DC table whose last symbol is a magnitude above 15 bits is refused,
    as libjpeg refuses it (cv2 and the JAX library); 12-15 decode as there."""
    rng = np.random.default_rng(symbol)
    img = rng.integers(0, 255, (24, 40) if gray else (24, 40, 3), np.uint8)
    data = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    p, _, _, count = next(t for t in dht_tables(data) if t[1] == 0)  # the first DC table
    data[p + 17 + count - 1] = symbol  # its rarest symbol, the longest code
    data = bytes(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if symbol > 15:
        assert want is None
        with pytest.raises(IOError, match="bad DC magnitude"):
            lib.decode_jpeg(data)
        with pytest.raises(IOError):
            jax_lib.decode_jpeg(data)
    else:
        np.testing.assert_array_equal(lib.decode_jpeg(data), want)
        np.testing.assert_array_equal(lib.decode_jpeg(data), jax_lib.decode_jpeg(data))


# ---------------------------------------------------------------- resize


def test_resize_matches_jax_upscale(lib, jax_lib):
    img = np.random.default_rng(1).integers(0, 255, (100, 140, 3), dtype=np.uint8)
    np.testing.assert_array_equal(lib.resize_bilinear(img, 256, 342),
                                  jax_lib.resize_bilinear(img, 256, 342))


def test_resize_matches_jax_downscale(lib, jax_lib):
    img = np.random.default_rng(2).integers(0, 255, (256, 342), dtype=np.uint8)
    np.testing.assert_array_equal(lib.resize_bilinear(img, 64, 85),
                                  jax_lib.resize_bilinear(img, 64, 85))


# ------------------------------------------------------------------- WAV


@pytest.mark.parametrize("sr", [24000, 48000, 44100, 16000])
def test_read_wav_matches_jax(lib, jax_lib, tmp_path, sr):
    path = str(tmp_path / "a.wav")
    write_wav(path, tone(sr), sr)
    out = lib.read_wav(path, target_sr=24000)
    assert out.dtype == np.float32 and abs(len(out) - 48000) <= 1
    np.testing.assert_array_equal(out, jax_lib.read_wav(path, target_sr=24000))
    assert abs(np.argmax(np.abs(np.fft.rfft(out[:24000]))) - 440) <= 2


def test_short_fmt_chunk_rejected(lib, tmp_path):
    path = str(tmp_path / "badfmt.wav")
    write_riff(path, [(b"fmt ", pcm_fmt(24000)[:14]), (b"data", np.zeros(100, "<i2").tobytes())])
    with pytest.raises(IOError):
        lib.read_wav(path, target_sr=24000)


def test_odd_sized_junk_chunk_skipped(lib, jax_lib, tmp_path):
    path = str(tmp_path / "junk.wav")
    pcm = (np.full(24000, 0.25, np.float32) * 32767).astype("<i2").tobytes()
    write_riff(path, [(b"LIST", b"junk!"), (b"fmt ", pcm_fmt(24000)), (b"data", pcm)])
    out = lib.read_wav(path, target_sr=24000)
    assert len(out) == 24000
    np.testing.assert_array_equal(out, jax_lib.read_wav(path, target_sr=24000))


def test_stereo_downmix(lib, jax_lib, tmp_path):
    path = str(tmp_path / "st.wav")
    inter = np.empty(2 * 24000)
    inter[0::2], inter[1::2] = tone(24000, 1.0, seed=1), tone(24000, 1.0, seed=2)
    write_wav(path, inter, 24000, channels=2)
    for sr in (24000, 16000):
        np.testing.assert_array_equal(lib.read_wav(path, target_sr=sr),
                                      jax_lib.read_wav(path, target_sr=sr))


def test_truncated_data_chunk_returns_short(lib, jax_lib, tmp_path):
    path = tmp_path / "trunc.wav"
    write_wav(path, np.full(24000, 0.5), 24000)
    with open(path, "r+b") as handle:
        handle.truncate(path.stat().st_size - 24000)  # half of the 48000 data bytes
    out = lib.read_wav(str(path), target_sr=24000)
    assert len(out) == 12000 and np.all(np.abs(out) > 0.4)
    np.testing.assert_array_equal(out, jax_lib.read_wav(str(path), target_sr=24000))


# ------------------------------------------------------------------ batch


def test_batch_pipeline_matches_jax(lib, jax_lib, tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(6):
        img = cv2.GaussianBlur(rng.integers(0, 255, (300, 400, 3), dtype=np.uint8), (15, 15), 5)
        paths.append(str(tmp_path / f"f{i}.jpg"))
        cv2.imwrite(paths[-1], img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    for grayscale in (False, True):
        out = lib.decode_batch(paths, scale_size=256, crop_size=224, grayscale=grayscale,
                               num_threads=3)
        assert out.shape == (6, 224, 224, 1 if grayscale else 3)
        np.testing.assert_array_equal(out, jax_lib.decode_batch(
            paths, scale_size=256, crop_size=224, grayscale=grayscale, num_threads=3))


def test_batch_missing_file(lib, tmp_path):
    with pytest.raises(IOError):
        lib.decode_batch([str(tmp_path / "missing.jpg")], 256, 224)


def test_batch_crop_larger_than_scale_fails(lib, tmp_path):
    p = str(tmp_path / "small.jpg")
    cv2.imwrite(p, np.full((300, 400, 3), 127, np.uint8))
    with pytest.raises(IOError):
        lib.decode_batch([p], scale_size=64, crop_size=224)


# ------------------------------------------------------------ gate, build


def test_read_audio_sample_honors_native_gate(tmp_path, monkeypatch):
    """use_native=False (tpu.native_io=false) reads through the Python
    reader even where the library builds."""
    (tmp_path / "audio").mkdir()
    write_wav(tmp_path / "audio" / "P01_01.wav", tone(48000, 0.5), 48000)

    def boom(*args, **kwargs):
        raise AssertionError("native reader used despite the gate")

    monkeypatch.setattr(native.Library, "read_wav", boom)
    out = audio.read_audio_sample(str(tmp_path), "audio", "P01_01", use_native=False)
    np.testing.assert_array_equal(out, audio.read_wav(str(tmp_path / "audio" / "P01_01.wav")))
    with pytest.raises(AssertionError, match="despite"):
        audio.read_audio_sample(str(tmp_path), "audio", "P01_01")


def test_missing_compiler_raises_under_native_io(tmp_path, monkeypatch):
    """No compiler and no built library: tpu.native_io=true raises and
    names the compiler; tpu.native_io=false needs no library."""
    monkeypatch.setattr(native, "COMPILER", "no-such-g++-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_library", None)
    ann = tmp_path / "annotations"
    ann.mkdir()
    (ann / "a.csv").write_text("uid,participant_id,video_id,start_timestamp,stop_timestamp,"
                               "start_frame,stop_frame\n0,P01,P01_01,00:00:00.00,"
                               "00:00:01.00,2,30\n")
    over = [f"data_dir={tmp_path}", "data.flow.enable=false"]
    with pytest.raises(native.NativeBuildError, match="no-such-g\\+\\+-compiler"):
        dataset.VideoDataset(load_config(overrides=over), None, "annotations/a.csv", ["RGB"],
                             mode="test")
    assert not native.available()
    ds = dataset.VideoDataset(load_config(overrides=over + ["tpu.native_io=false"]), None,
                              "annotations/a.csv", ["RGB"], mode="test")
    assert ds.native is None and len(ds) == 1


# ---------------------------------------------- the decoder against libjpeg

SAMPLINGS = {"420": None, "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, "gray": None}


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_codec_decode_bit_equal_to_libjpeg(lib, jax_lib, quality, sampling):
    """Odd and block-aligned sizes, a 1-pixel image, with and without
    restart intervals: BGR and gray decodes equal libjpeg's, through the
    JAX package's library and through cv2."""
    rng = np.random.default_rng(quality)
    for h, w in ((257, 343), (256, 456), (17, 33), (1, 1)):
        img = rng.integers(0, 255, (h, w) if sampling == "gray" else (h, w, 3), np.uint8)
        if min(h, w) > 8:
            img = cv2.GaussianBlur(img, (7, 7), 2)
        for restart in (0, 3):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
            if SAMPLINGS[sampling] is not None:
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
            data = cv2.imencode(".jpg", img, params)[1].tobytes()
            buf = np.frombuffer(data, np.uint8)
            for grayscale in (False, True):
                got = lib.decode_jpeg(data, grayscale)
                where = f"{(h, w)} restart {restart} gray {grayscale}"
                np.testing.assert_array_equal(got, jax_lib.decode_jpeg(data, grayscale),
                                              err_msg=where)
                flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
                np.testing.assert_array_equal(got, cv2.imdecode(buf, flag), err_msg=where)


# ----------------------------------------------------------- test data

CHECKSUMS = "checksums.json"


def make_jpegs(directory):
    """The committed JPEGs, written with cv2 from seed 11: Epic-Kitchens-55's
    256 x 456 frames (4:2:0 at 95, 4:4:4 at 90, 4:2:0 with a restart every
    4 MCUs at 75), two gray Flow maps, and a 4:2:2 frame of odd size."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:256, 0:456]
    base = np.stack([(xx * 255 // 455), (yy * 255 // 255), ((xx + yy) % 256)], -1)
    noise = cv2.GaussianBlur(rng.integers(0, 255, (256, 456, 3), np.uint8), (9, 9), 3)
    frame = ((base.astype(np.int32) + noise) // 2).astype(np.uint8)
    flow = cv2.GaussianBlur(rng.integers(0, 255, (2, 256, 456), np.uint8).transpose(1, 2, 0),
                            (11, 11), 4)
    odd = cv2.GaussianBlur(rng.integers(0, 255, (257, 343, 3), np.uint8), (7, 7), 2)
    files = {
        "rgb_420_q95.jpg": (frame, [cv2.IMWRITE_JPEG_QUALITY, 95]),
        "rgb_444_q90.jpg": (frame, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
        "rgb_420_q75_restart4.jpg": (frame, [cv2.IMWRITE_JPEG_QUALITY, 75,
                                             cv2.IMWRITE_JPEG_RST_INTERVAL, 4]),
        "flow_x.jpg": (np.ascontiguousarray(flow[..., 0]), [cv2.IMWRITE_JPEG_QUALITY, 95]),
        "flow_y.jpg": (np.ascontiguousarray(flow[..., 1]), [cv2.IMWRITE_JPEG_QUALITY, 95]),
        "odd_422_257x343.jpg": (odd, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    }
    for name, (img, params) in files.items():
        cv2.imwrite(os.path.join(directory, name), img, params)
    return sorted(files)


def sha256(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def make_testdata(directory):
    """The JPEGs, a 1 s 48 kHz mono WAV (seed 12), and ``checksums.json``:
    the SHA-256 of cv2's BGR and gray decodes of each JPEG, and of the JAX
    library's ``read_wav`` of the WAV at 24 kHz (float32 bytes)."""
    jpegs = make_jpegs(directory)
    wav = os.path.join(directory, "tone_48k.wav")
    write_wav(wav, tone(48000, 1.0, seed=12), 48000)
    record = {"jpeg": {}, "wav": {}}
    for name in jpegs:
        path = os.path.join(directory, name)
        bgr, gray = cv2.imread(path), cv2.imread(path, 0)
        record["jpeg"][name] = {"shape": list(bgr.shape), "bgr_sha256": sha256(bgr),
                                "gray_sha256": sha256(gray)}
    samples = jax_native.read_wav(wav, target_sr=24000)
    record["wav"]["tone_48k.wav"] = {"target_sr": 24000, "samples": int(samples.shape[0]),
                                     "float32_sha256": sha256(samples.astype(np.float32))}
    with open(os.path.join(directory, CHECKSUMS), "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def test_committed_testdata_regenerates(jax_lib, tmp_path):
    """The committed files are what make_testdata writes here: the same
    bytes and the same checksums of cv2's decodes and the JAX reader."""
    make_testdata(str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f for f in os.listdir(TESTDATA) if not f.startswith("."))
    for name in names:
        with open(tmp_path / name, "rb") as got, open(os.path.join(TESTDATA, name), "rb") as want:
            assert got.read() == want.read(), name


def test_testdata_decodes_to_its_checksums(lib):
    """What chip_smoke.py's native_io phase holds the card's build to."""
    with open(os.path.join(TESTDATA, CHECKSUMS)) as fh:
        record = json.load(fh)
    assert len(record["jpeg"]) == 6
    for name, want in record["jpeg"].items():
        path = os.path.join(TESTDATA, name)
        bgr = lib.decode_jpeg_file(path)
        assert list(bgr.shape) == want["shape"]
        assert sha256(bgr) == want["bgr_sha256"], name
        assert sha256(lib.decode_jpeg_file(path, grayscale=True)) == want["gray_sha256"], name
    for name, want in record["wav"].items():
        samples = lib.read_wav(os.path.join(TESTDATA, name), want["target_sr"])
        assert samples.shape == (want["samples"],)
        assert sha256(samples) == want["float32_sha256"]


def test_build_is_keyed_by_its_sources(tmp_path, monkeypatch):
    """An edited source gets another library path, so a stale build is
    never loaded; a build goes through a temporary file and a rename."""
    copy = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, copy, ignore=shutil.ignore_patterns("_build", "testdata",
                                                                            "__pycache__"))
    monkeypatch.setattr(native, "NATIVE_DIR", str(copy))
    monkeypatch.setattr(native, "BUILD_DIR", str(copy / "_build"))
    before = native.library_path()
    assert native.build() > 0 and os.path.exists(before)
    assert native.build() == 0.0
    for name in native.SOURCES + native.HEADERS:
        with open(copy / name, "a") as fh:
            fh.write("\n// edited\n")
        after = native.library_path()
        assert after != before and not os.path.exists(after), name
        before = after
    assert not [f for f in os.listdir(copy / "_build") if f.endswith(".tmp")]
