"""The PyTorch port's host tools and demo entry point against the JAX
package's, on the same seeded inputs: the native host runtime
(``native.py``), ``FrameSequence``'s prefetch, ``viz``, ``debug`` and the
demo CLI (``cli.py``).

Tolerances:
  - native runtime, frame sequences, PNG bytes and drawings: exactly (the
    same C++ source, the same numpy code);
  - ``debug_planes``, float path: planes within 1e-5 of each plane's max
    |value| (the scale-space parity tolerance of
    tests/test_torch_sublevel.py; on the CPU both sides take the op path,
    det included), kcontrast within 1e-6 relative, the layer and size maps
    and the NMS mask exactly; fixed path: every plane bit for bit;
  - the CLI: keypoint and match counts exactly, against the JAX pair path
    on the same files; the PNG files drawn from the port's features against
    those the JAX package's ``viz`` draws from JAX's features: byte for
    byte, float path too (keypoint x/y differ by up to 1.5e-5 px there,
    P1-1, which moves no drawn pixel on these inputs: 0 differ).
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu import Akaze as JAkaze
from akaze_tpu import AkazeConfig as JConfig
from akaze_tpu import debug as jdebug
from akaze_tpu import native as jnative
from akaze_tpu import viz as jviz
from akaze_tpu.io import FrameSequence as JFrameSequence
from akaze_tpu.io import load_gray as jload_gray
from akaze_tpu.plan import build_plan as jbuild_plan
from akaze_tpu_torch import _build, build_plan, cli, config_from
from akaze_tpu_torch import debug as tdebug
from akaze_tpu_torch import native as tnative
from akaze_tpu_torch import viz as tviz
from akaze_tpu_torch.descriptor import words_to_numpy
from akaze_tpu_torch.fed import fed_tau_by_process_time
from akaze_tpu_torch.io import FrameSequence, load_pgm, save_pgm
from akaze_tpu_torch.io import synthetic_sequence
from akaze_tpu_torch.match import match

torch.set_num_threads(1)

PLANE_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both packages' native libraries; skips without a C++ toolchain.

    Where the JAX package has not loaded its library yet, its unedited
    source is built into a temporary directory instead of native/, so that
    these tests write nothing under native/ (the JAX package's own tests
    build it there)."""
    with pytest.MonkeyPatch.context() as mp:
        if not jnative._tried:
            mp.setattr(jnative, "_SO", str(
                tmp_path_factory.mktemp("jax_native") / "libakaze_native.so"))
        tlib, jlib = tnative.get_lib(), jnative.get_lib()
        if tlib is None or jlib is None:
            pytest.skip("native toolchain unavailable")
        yield tlib, jlib


def write_frames(d, rng, n, shape=(9, 11)):
    """``n`` seeded uint8 frames as ``f{i:02d}.pgm`` under ``d``."""
    paths, imgs = [], []
    for i in range(n):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        p = str(d / f"f{i:02d}.pgm")
        save_pgm(p, img)
        paths.append(p)
        imgs.append(img)
    return paths, imgs


def descriptor_words(rng, n):
    w = rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)
    w[:, 15] &= np.uint32((1 << 6) - 1)          # the 486 live bits
    return w


# --------------------------------------------------------------------------
# native host runtime
# --------------------------------------------------------------------------

def test_native_fed_taus_match_jax(libs):
    for t, reorder in [(0.5, True), (0.5, False), (2.3, True),
                       (0.08, True), (7.9, False)]:
        got = tnative.fed_tau_native(t, 0.25, reorder)
        np.testing.assert_array_equal(
            got, jnative.fed_tau_native(t, 0.25, reorder))
        py = np.asarray(fed_tau_by_process_time(t, 1, 0.25, reorder),
                        np.float32)
        np.testing.assert_allclose(np.sort(got), np.sort(py), rtol=1e-4)


def test_native_pgm_decode_with_a_comment(libs, tmp_path, rng):
    img = rng.integers(0, 256, (17, 23), dtype=np.uint8)
    p = str(tmp_path / "x.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n23 17\n255\n" + img.tobytes())
    got = tnative.load_pgm_native(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jnative.load_pgm_native(p))
    np.testing.assert_array_equal(got, load_pgm(p))
    with pytest.raises(IOError):
        tnative.load_pgm_native(str(tmp_path / "missing.pgm"))


@pytest.mark.parametrize("n, threads, prefetch", [(8, 3, 2), (16, 4, 1)])
def test_frame_loader_in_order(libs, tmp_path, rng, n, threads, prefetch):
    """In order; (16, 4, 1) is the deadlock case of tests/test_native.py
    (more workers than queue capacity), run three times."""
    paths, imgs = write_frames(tmp_path, rng, n)
    for _ in range(3 if prefetch == 1 else 1):
        loader = tnative.FrameLoader(paths, n_threads=threads,
                                     prefetch=prefetch)
        got = list(loader)
        loader.close()
        want = list(jnative.FrameLoader(paths, n_threads=threads,
                                        prefetch=prefetch))
        assert len(got) == len(want) == n
        for g, w, i in zip(got, want, imgs):
            np.testing.assert_array_equal(g, i)
            np.testing.assert_array_equal(g, w)


def test_frame_loader_early_close(libs, tmp_path, rng):
    """Closing mid-stream joins the workers."""
    paths, imgs = write_frames(tmp_path, rng, 8)
    loader = tnative.FrameLoader(paths, n_threads=3, prefetch=2)
    np.testing.assert_array_equal(next(loader), imgs[0])
    loader.close()
    loader.close()


def test_native_hamming_matches_jax_and_match(libs, rng):
    n1, n2 = 64, 96
    w1, w2 = descriptor_words(rng, n1), descriptor_words(rng, n2)
    w2[10] = w1[3]
    w2[20] = w1[7]
    t1 = torch.from_numpy(w1.view(np.int32))
    t2 = torch.from_numpy(w2.view(np.int32))
    idx, dist = tnative.hamming_match_native(words_to_numpy(t1),
                                             words_to_numpy(t2), 96)
    idx_j, dist_j = jnative.hamming_match_native(w1, w2, 96)
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(dist, dist_j)
    m = match(t1, torch.ones(n1, dtype=torch.bool), t2,
              torch.ones(n2, dtype=torch.bool), torch.zeros(n2),
              torch.zeros(n2), 96)
    np.testing.assert_array_equal(idx, m.index.numpy())
    np.testing.assert_array_equal(dist, m.distance.numpy().astype(np.int32))
    assert idx[3] == 10 and idx[7] == 20
    with pytest.raises(ValueError):
        tnative.hamming_match_native(t1.numpy(), w2)


def test_fallbacks_without_the_library(monkeypatch, tmp_path, rng):
    """With ``get_lib`` patched to None the functions return None (callers
    fall back) and ``FrameLoader`` decodes the same frames in Python."""
    paths, imgs = write_frames(tmp_path, rng, 5)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tnative.fed_tau_native(0.5, 0.25, True) is None
    assert tnative.load_pgm_native(paths[0]) is None
    assert tnative.hamming_match_native(descriptor_words(rng, 2),
                                        descriptor_words(rng, 3)) is None
    loader = tnative.FrameLoader(paths, n_threads=4, prefetch=1)
    got = list(loader)
    loader.close()
    assert len(got) == 5
    for g, i in zip(got, imgs):
        np.testing.assert_array_equal(g, i)
    for g, i in zip(FrameSequence(str(tmp_path)), imgs):
        np.testing.assert_array_equal(g, i)


def test_library_builds_under_the_port_only(libs, monkeypatch, tmp_path):
    """The port builds its own copy of the source into its build directory
    (here a temporary one), by a hash of source and flags, and writes
    nothing under the JAX package's native/."""
    assert tnative.SOURCE.is_relative_to(
        os.path.join(REPO, "akaze_tpu_torch"))
    assert (tnative.SOURCE.read_bytes()
            == open(os.path.join(REPO, "native", "akaze_native.cpp"),
                    "rb").read())
    assert tnative.library_path().parent == _build.BUILD_DIR
    native_dir = os.path.join(REPO, "native")
    before = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
              for f in os.listdir(native_dir)}
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    lib = tnative._build()
    assert lib == tnative.library_path() and lib.parent == tmp_path
    assert lib.exists()
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]
    after = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
             for f in os.listdir(native_dir)}
    assert after == before


# --------------------------------------------------------------------------
# FrameSequence
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [True, False])
def test_frame_sequence_matches_jax(libs, monkeypatch, tmp_path, prefetch):
    frames, _ = synthetic_sequence(np.random.default_rng(3), n_frames=6,
                                   size=(48, 64))
    for i, f in enumerate(frames):
        save_pgm(str(tmp_path / f"{i:06d}.pgm"), f)
    made = []

    class Counting(tnative.FrameLoader):
        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(tnative, "FrameLoader", Counting)
    seq = FrameSequence(str(tmp_path), prefetch=prefetch)
    got = list(seq)
    want = list(JFrameSequence(str(tmp_path), prefetch=prefetch))
    assert len(seq) == len(got) == len(want) == 6
    for g, w, f in zip(got, want, frames):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(g, w)
    assert len(made) == (1 if prefetch else 0)


# --------------------------------------------------------------------------
# viz
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 53), (24, 31, 3)])
def test_png_bytes_equal_jax(tmp_path, rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    tviz.write_png(str(tmp_path / "t.png"), img)
    jviz.write_png(str(tmp_path / "j.png"), img)
    assert ((tmp_path / "t.png").read_bytes()
            == (tmp_path / "j.png").read_bytes())
    np.testing.assert_array_equal(tviz.read_png(str(tmp_path / "t.png")),
                                  img)
    (tmp_path / "bad.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        tviz.read_png(str(tmp_path / "bad.png"))


def test_drawings_equal_jax(rng):
    g1 = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    g2 = rng.random((64, 80)).astype(np.float32)
    x, y = rng.uniform(0, 80, 30), rng.uniform(0, 64, 30)
    size = rng.uniform(1, 9, 30)
    valid = rng.random(30) > 0.2
    np.testing.assert_array_equal(tviz.draw_keypoints(g1, x, y, size, valid),
                                  jviz.draw_keypoints(g1, x, y, size, valid))
    np.testing.assert_array_equal(tviz.to_rgb(g2), jviz.to_rgb(g2))
    mx, my = x + 3, y - 2
    for horizontal in (True, False):
        np.testing.assert_array_equal(
            tviz.draw_matches(g1, g2, x, y, mx, my, valid, horizontal),
            jviz.draw_matches(g1, g2, x, y, mx, my, valid, horizontal))


# --------------------------------------------------------------------------
# debug
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["float", "fixed"])
def debug_pair(request, test_image):
    """Both packages' planes of the test image (the configuration of
    tests/test_dataset_cli.py::TestDebugPlanes); raw 0..255 when fixed."""
    fixed = request.param
    cfg = JConfig(max_pts=128, noctaves=2)
    image = ((test_image * 255).astype(np.int32) if fixed
             else test_image)
    want = jdebug.debug_planes(jnp.asarray(image),
                               jbuild_plan(*image.shape, cfg), fixed)
    got = tdebug.debug_planes(image, build_plan(*image.shape,
                                                config_from(cfg.__dict__)),
                              fixed, device="cpu")
    return fixed, got, want


def test_debug_planes_match_jax(debug_pair, tmp_path):
    fixed, got, want = debug_pair
    assert list(got) == list(want)
    assert "L0_0" in got and "det1_3" in got
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if fixed or k in ("layer_map", "size_map", "nms_mask"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "kcontrast":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            scale = max(float(np.abs(w[w > -1e5]).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=PLANE_TOL * scale,
                                       err_msg=k)
    assert got["nms_mask"].dtype == bool and got["nms_mask"].sum() > 10

    # dump_planes: the same PNG bytes; from each package's own planes where
    # they are equal (fixed), else from the same planes
    src = want if fixed else got
    pick = dict(src, scalar=np.float32(1.0))       # not 2-D: skipped
    tdebug.dump_planes(dict(got if fixed else pick), str(tmp_path / "t"))
    jdebug.dump_planes(pick, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert "response_map.png" in names and "kcontrast.png" not in names
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes()), n


# --------------------------------------------------------------------------
# the demo CLI: the slice's entry point
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_pair(tmp_path_factory):
    """Two 160x200 frames of ``synthetic_sequence`` as PGM files (the
    set-up of tests/test_dataset_cli.py::TestCli)."""
    d = tmp_path_factory.mktemp("cli")
    frames, _ = synthetic_sequence(np.random.default_rng(42), n_frames=2,
                                   size=(160, 200),
                                   shift_per_frame=(2.0, 3.0))
    lp, rp = str(d / "l.pgm"), str(d / "r.pgm")
    save_pgm(lp, frames[0])
    save_pgm(rp, frames[1])
    return lp, rp


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


@pytest.mark.parametrize("fixed", [False, True])
def test_cli_matches_the_jax_pair_path(cli_pair, tmp_path, fixed):
    lp, rp = cli_pair
    flag = ["--fixed"] if fixed else []
    rec = json.loads(run_cli(
        ["--left", lp, "--right", rp, "--iters", "1", "--max-pts", "512",
         "--out-dir", str(tmp_path), "--json", "--device", "cpu"]
        + flag).strip().splitlines()[-1])
    assert set(rec) == {"left_pts", "right_pts", "matches",
                        "detect_pair_ms", "match_ms", "compile_s",
                        "overflow", "fixed", "backend"}
    assert rec["backend"] == "cpu" and rec["fixed"] is fixed
    assert rec["detect_pair_ms"] > 0 and rec["match_ms"] > 0

    left, right = jload_gray(lp), jload_gray(rp)
    ins = ((left, right) if fixed else
           (left.astype(np.float32) / 255.0, right.astype(np.float32) / 255.0))
    jdet = JAkaze(JConfig(max_pts=512), fixed=fixed)
    fa, fb = jdet.detect_and_compute_pair(*ins)
    m = jdet.match(fa, fb)
    na = int(fa.count)
    acc = np.asarray(m.index)[:na] >= 0
    assert (rec["left_pts"], rec["right_pts"], rec["matches"]) == (
        na, int(fb.count), int(acc.sum()))
    assert rec["left_pts"] > 5 and rec["matches"] > 3
    assert rec["overflow"] == (bool(fa.overflow) or bool(fb.overflow))

    tag = "fastakaze" if fixed else "akaze"
    x, y, size = (np.asarray(v)[:na] for v in (fa.x, fa.y, fa.size))
    want_kp = jviz.draw_keypoints(left, x, y, size)
    want_mm = jviz.draw_matches(left, right, x, y,
                                np.asarray(m.match_x)[:na],
                                np.asarray(m.match_y)[:na], acc,
                                horizontal=left.shape[1] <= left.shape[0])
    for name, want in (("keypoints", want_kp), ("matches", want_mm)):
        jviz.write_png(str(tmp_path / f"jax_{name}.png"), want)
        assert ((tmp_path / f"{tag}_{name}.png").read_bytes()
                == (tmp_path / f"jax_{name}.png").read_bytes()), name


def test_cli_text_output_and_no_draw(cli_pair, tmp_path):
    lp, rp = cli_pair
    text = run_cli(["--left", lp, "--right", rp, "--iters", "1",
                    "--max-pts", "512", "--out-dir", str(tmp_path),
                    "--no-draw", "--device", "cpu"])
    assert "Number of features:" in text and "Matched features:" in text
    assert not os.listdir(tmp_path)


def test_cli_refuses_spatial_and_missing_files(cli_pair, tmp_path,
                                               monkeypatch, capsys):
    lp, rp = cli_pair
    with pytest.raises(SystemExit) as e:     # 160 rows over 3 shards
        cli.main(["--left", lp, "--right", rp, "--device", "cpu",
                  "--spatial", "3"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--spatial 3: spatial sharding unsupported for 160x" in err
    assert "octave 0 height 160 not divisible" in err
    with pytest.raises(FileNotFoundError):
        cli.main(["--left", str(tmp_path / "absent.pgm"), "--right", rp,
                  "--device", "cpu"])
    with pytest.raises(SystemExit) as e:      # no default pair to fall to
        cli.main(["--right", rp, "--device", "cpu"])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cli.main(["--left", lp, "--right", rp, "--no-draw"])
