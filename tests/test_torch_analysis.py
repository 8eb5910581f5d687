"""The port's analysis tools and bench against the JAX package, on the CPU
at the tiny fixture: ``rd_curves`` (BD-rate, BD-PSNR), ``draw_weight``
(per-layer channel ranges and kurtosis from one ``.pth``),
``loss_landscape`` (surface, line, trajectory: the losses, the PCA
directions and projections, the ``.h5`` files), and
``neuroquant_tpu_torch.bench`` at the fixture's size.

The JAX package's loss landscape vmaps its grid points, which its packed
tail cannot (``tests/test_analysis.py``'s four known failures), so its side
runs with ``packed_tail: off``; the port runs its default path, the fused
tail (on the CPU its kernels' plain versions), one decode a point. The
port draws its directions from a ``torch.Generator``; the JAX ones go in
through ``dirs=``.

Tolerances: BD figures 1e-9 (the same numpy); weight statistics 1e-6
relative (the same fp32 weights, reduced in float64 by numpy); losses 1e-5
relative; PCA directions up to sign 1e-5 of their largest entry; a grid
point against a fresh decode at its weights 1e-6 relative."""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.analysis import draw_weight as jdw
from neuroquant_tpu.analysis import loss_landscape as jll
from neuroquant_tpu.analysis import rd_curves as jrd
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import quant_layer_paths
from neuroquant_tpu.quantization.qmodel import _get
from neuroquant_tpu.utils.torch_compat import load_pth as jax_load_pth
from neuroquant_tpu.utils.torch_compat import save_pth
from neuroquant_tpu_torch.analysis import draw_weight as tdw
from neuroquant_tpu_torch.analysis import loss_landscape as tll
from neuroquant_tpu_torch.analysis import rd_curves as trd
from neuroquant_tpu_torch.data import VideoDataSet
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.quantization.spec import make_spec

LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def files(tiny_hnerv_cfg, frame_dir, tmp_path_factory):
    """One .pth of the JAX init, four snapshots on a path ending at it
    (the last is the .pth itself), the port's yaml and the JAX side's
    (``packed_tail: off``)."""
    d = tmp_path_factory.mktemp("analysis")
    cfg = dict(tiny_hnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = jax_build_model("hnerv", cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    ck = str(d / "ck.pth")
    save_pth(ck, "hnerv", params)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(1)
    steps = [rng.randn(*np.shape(v)).astype(np.float32) for v in leaves]
    for i in range(4):
        far = (3 - i) / 3 + 0.3 * (3 - i) ** 2 / 9
        snap = [np.asarray(v) + 0.02 * far * s * (1 + 0.5 * (j % 3))
                for j, (v, s) in enumerate(zip(leaves, steps))]
        save_pth(str(d / f"epoch{i + 1}.pth"), "hnerv",
                 jax.tree_util.tree_unflatten(tree, snap))
    for name, extra in (("port", {}), ("jax", {"packed_tail": "off"})):
        with open(d / f"{name}.yaml", "w") as f:
            yaml.safe_dump(dict(cfg, **extra), f)
    return dict(dir=d, cfg=cfg, ck=ck, frames=frames)


class TestRDCurves:
    @pytest.mark.parametrize("anchor,test", [
        ("NeRV", "NeRV-VR"), ("HNeRV", "HNeRV-VR"), ("x265", "DCVC"),
        ("HiNeRV*", "HiNeRV-VR"), ("x264", "D-CABAC")])
    def test_bd_figures_match_jax(self, anchor, test):
        a, t = trd.PUBLISHED_UVG[anchor], trd.PUBLISHED_UVG[test]
        for fn, jfn in ((trd.bd_rate, jrd.bd_rate),
                        (trd.bd_psnr, jrd.bd_psnr)):
            got = fn(a["bpp"], a["psnr"], t["bpp"], t["psnr"])
            want = jfn(a["bpp"], a["psnr"], t["bpp"], t["psnr"])
            assert np.isfinite(got)
            assert abs(got - want) <= 1e-9, (fn.__name__, got, want)

    def test_table_and_main_match_jax(self, tmp_path, capsys):
        assert trd.PUBLISHED_UVG == jrd.PUBLISHED_UVG
        outs = []
        for mod, name in ((trd, "port"), (jrd, "jax")):
            mod.main(["--out", str(tmp_path / f"{name}.png"), "--bd",
                      "HNeRV", "HNeRV-VR"])
            line = json.loads(capsys.readouterr().out.strip())
            assert os.path.getsize(line.pop("plot")) > 5000
            outs.append(line)
        assert outs[0] == outs[1] and outs[0]["bd_rate_pct"] < 0


class TestDrawWeight:
    def test_layer_statistics_match_jax(self, files):
        """Per layer: the names, the HWIO kernels' per-channel min and max
        and the kurtosis of the JAX package's load of the same .pth."""
        cfg = files["cfg"]
        jm = jax_build_model("hnerv", cfg)
        params = jm.init(jax.random.PRNGKey(5),
                         jnp.asarray(files["frames"][:1]))
        params = jax_load_pth(files["ck"], "hnerv", params)
        got = tdw.layer_weights("hnerv", cfg, files["ck"], "cpu")
        paths = quant_layer_paths("hnerv", cfg)
        assert [n for n, _ in got] == ["/".join(p) for p in paths]
        for (name, w), path in zip(got, paths):
            want = np.asarray(_get(params, tuple(path))["kernel"])
            assert w.shape == want.shape, name
            for g, x in zip(tdw.channel_minmax(w), jdw.channel_minmax(want)):
                np.testing.assert_allclose(g, x, rtol=1e-6, atol=0)
            assert abs(tdw._kurtosis(w) - jdw._kurtosis(want)) <= 1e-6 * abs(
                jdw._kurtosis(want)), name

    def test_main_writes_a_plot_per_layer(self, files):
        out = str(files["dir"] / "plots_w")
        paths = tdw.main(["--config", str(files["dir"] / "port.yaml"),
                          "--arch", "hnerv", "--ckpt", files["ck"],
                          "--out", out, "--device", "cpu"])
        assert len(paths) == 5
        for p in paths:
            assert os.path.exists(p) and os.path.getsize(p) > 1000


def _jax_kernels(cfg, ck, frames, lid=-1, b_w=0):
    """The JAX package's centre kernels (HWIO), layer `lid` quantized as
    its compute_surface does."""
    jm = jax_build_model("hnerv", dict(cfg, packed_tail="off"))
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(frames[:1]))
    params = jax_load_pth(ck, "hnerv", params)
    paths = [tuple(p) for p in quant_layer_paths("hnerv", cfg)]
    kernels = [_get(params, p)["kernel"] for p in paths]
    if lid >= 0 and b_w > 0:
        kernels[lid] = jll.symmetric_quantize_layer(kernels[lid], b_w)
    return kernels


def _main_args(files, frame_dir, name, out, *extra):
    return ["--config", str(files["dir"] / f"{name}.yaml"), "--arch",
            "hnerv", "--ckpt", files["ck"], "--data_path", frame_dir,
            "--batch", "2", "--chunk", "3", "--out", out, *extra]


def _h5_layout(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v.shape)
                     if isinstance(v, h5py.Dataset) else None)
    return out


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=0,
                               err_msg=what)


class TestLossLandscape:
    def test_surface_matches_jax(self, files, frame_dir):
        """A 3x3 surface with layer 1 quantized to 2 bits: the JAX main's
        surface (its own directions) against the port's compute_surface
        on those directions; then the port's main writes the JAX main's
        .h5 datasets, shapes and coordinates."""
        d = files["dir"]
        grid = ["--x=-0.5:0.5:3", "--y=-0.5:0.5:3", "--lid", "1", "--b_w",
                "2"]
        want = jll.main(_main_args(files, frame_dir, "jax",
                                   str(d / "j_surf"), *grid))
        kernels = _jax_kernels(files["cfg"], files["ck"], files["frames"],
                               lid=1, b_w=2)
        r1, r2 = jax.random.split(jax.random.PRNGKey(123))
        dirs = [[np.asarray(t) for t in jll.filter_normalized_direction(
            r, kernels)] for r in (r1, r2)]
        model, keys, data = _port_model(files, frame_dir)
        xs = ys = np.linspace(-0.5, 0.5, 3)
        got = tll.compute_surface(model, keys, data.frames, data.norm_idx,
                                  xs, ys, np.arange(2), chunk=3, lid=1,
                                  b_w=2, dirs=dirs)
        _close(got, want, "surface")
        assert float(np.ptp(got)) > 0
        port = tll.main(_main_args(files, frame_dir, "port",
                                   str(d / "t_surf"), *grid, "--device",
                                   "cpu", "--export_vtp"))
        assert port.shape == (3, 3) and np.isfinite(port).all()
        assert abs(port[1, 1] - got[1, 1]) <= LOSS_TOL * got[1, 1]
        assert _h5_layout(d / "t_surf.h5") == _h5_layout(d / "j_surf.h5")
        with h5py.File(d / "t_surf.h5") as ft, h5py.File(d / "j_surf.h5") as fj:
            for k in ("xcoordinates", "ycoordinates"):
                np.testing.assert_array_equal(ft[k][:], fj[k][:])
        assert os.path.exists(d / "t_surf.png")
        assert os.path.exists(d / "t_surf.vtp")

    def test_line_matches_jax(self, files, frame_dir):
        d = files["dir"]
        grid = ["--mode", "line", "--x=-0.5:0.5:5"]
        want = jll.main(_main_args(files, frame_dir, "jax", str(d / "j_line"),
                                   *grid))
        kernels = _jax_kernels(files["cfg"], files["ck"], files["frames"])
        d1 = [np.asarray(t) for t in jll.filter_normalized_direction(
            jax.random.PRNGKey(123), kernels)]
        model, keys, data = _port_model(files, frame_dir)
        losses, psnr = tll.compute_line(model, keys, data.frames,
                                        data.norm_idx,
                                        np.linspace(-0.5, 0.5, 5),
                                        np.arange(2), chunk=3, dirs=d1)
        _close(losses, want, "line")
        np.testing.assert_allclose(psnr, -10 * np.log10(want + 1e-9),
                                   rtol=0, atol=1e-4)
        tll.main(_main_args(files, frame_dir, "port", str(d / "t_line"),
                            *grid, "--device", "cpu"))
        assert (_h5_layout(d / "t_line_1d.h5")
                == _h5_layout(d / "j_line_1d.h5"))
        assert os.path.exists(d / "t_line_1d.png")

    def test_trajectory_matches_jax(self, files, frame_dir):
        """PCA over the four snapshots: the directions up to sign, the
        explained variance, the projections, and the surface over them
        (the same numpy PCA, so the same directions); the three .h5 files
        with the JAX main's datasets and shapes."""
        d = files["dir"]
        snaps = str(d / "epoch*.pth")
        grid = ["--mode", "trajectory", "--ckpt_glob", snaps,
                "--x=-0.2:0.2:3", "--y=-0.2:0.2:3"]
        want = jll.main(_main_args(files, frame_dir, "jax", str(d / "j_traj"),
                                   *grid))
        got = tll.main(_main_args(files, frame_dir, "port", str(d / "t_traj"),
                                  *grid, "--device", "cpu"))
        for suffix in ("", "_dirs", "_proj_cos"):
            assert (_h5_layout(d / f"t_traj{suffix}.h5")
                    == _h5_layout(d / f"j_traj{suffix}.h5")), suffix
        with h5py.File(d / "t_traj_dirs.h5") as ft, \
                h5py.File(d / "j_traj_dirs.h5") as fj:
            _close(ft["explained_variance_ratio_"][:],
                   fj["explained_variance_ratio_"][:], "evr")
            signs = []
            for axis in ("xdirection", "ydirection"):
                t = np.concatenate([ft[axis][k][:].ravel()
                                    for k in sorted(ft[axis], key=int)])
                j = np.concatenate([fj[axis][k][:].ravel()
                                    for k in sorted(fj[axis], key=int)])
                sign = 1.0 if np.dot(t, j) >= 0 else -1.0
                np.testing.assert_allclose(sign * t, j, rtol=0,
                                           atol=1e-5 * np.abs(j).max())
                signs.append(sign)
        with h5py.File(d / "t_traj_proj_cos.h5") as ft, \
                h5py.File(d / "j_traj_proj_cos.h5") as fj:
            for k, sign in zip(("proj_xcoord", "proj_ycoord"), signs):
                np.testing.assert_allclose(sign * ft[k][:], fj[k][:],
                                           rtol=0, atol=1e-5)
            assert abs(ft["proj_xcoord"][-1]) < 1e-3
        # the same snapshots, so numpy's SVD of the same matrix: the same
        # signs, the same widened grid and surface
        assert signs == [1.0, 1.0]
        _close(got, want, "trajectory surface")

    def test_surface_points_are_fresh_decodes(self, files, frame_dir):
        """The stale-weights pin: on the fused tail (its packed weights
        kept between decodes until a parameter's version changes) every
        grid point's loss equals a decode by a freshly built model loaded
        with that point's weights, the surface is not constant, and the
        model's weights are the centre's again afterwards."""
        model, keys, data = _port_model(files, frame_dir)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        gen = torch.Generator().manual_seed(7)
        centre = [p.detach().permute(2, 3, 1, 0)
                  for p in (dict(model.named_parameters())[k] for k in keys)]
        dirs = [tll.filter_normalized_direction(gen, centre)
                for _ in range(2)]
        xs = ys = np.linspace(-0.5, 0.5, 3)
        surf = tll.compute_surface(model, keys, data.frames, data.norm_idx,
                                   xs, ys, np.arange(2), chunk=4, dirs=dirs)
        assert float(np.ptp(surf)) > 1e-6 * float(surf.max())
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
        img = data.frames[:2]
        for i, x in enumerate(xs):
            for j, y in enumerate(ys):
                sd = dict(before)
                for key, w, a, b in zip(keys, centre, *dirs):
                    sd[key] = (w + x * a + y * b).permute(3, 2, 0, 1)
                fresh = build_model("hnerv", files["cfg"], device="cpu")
                fresh.load_state_dict(sd, strict=True)
                fresh.eval()
                with torch.no_grad():
                    loss = float(torch.mean((fresh(img) - img) ** 2))
                assert abs(surf[i, j] - loss) <= 1e-6 * loss, (i, j)


def _port_model(files, frame_dir):
    from neuroquant_tpu_torch.methods.common import load_pth

    cfg = files["cfg"]
    model = build_model("hnerv", cfg, device="cpu")
    load_pth(files["ck"], model)
    model.eval()
    keys = [f"{pre}.weight" for pre in make_spec("hnerv", cfg).layer_keys]
    return model, keys, VideoDataSet(cfg, frame_dir, device="cpu")


@pytest.mark.parametrize("tool", ["draw_weight", "loss_landscape"])
def test_tools_need_a_card_unless_asked(files, frame_dir, monkeypatch, tool):
    """Without a card and without --device cpu the tools raise; they never
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", str(files["dir"] / "port.yaml"), "--arch", "hnerv",
            "--ckpt", files["ck"], "--out", str(files["dir"] / "nocard")]
    mod = {"draw_weight": tdw, "loss_landscape": tll}[tool]
    if tool == "loss_landscape":
        argv += ["--data_path", frame_dir]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


class TestBench:
    def test_run_at_the_fixture_size(self, tiny_hnerv_cfg):
        """The bench's calibration and decode FPS at the fixture's size: a
        finite steady rate from every phase-2 epoch after the first."""
        from neuroquant_tpu_torch import bench

        r = bench.run(24, 2, 8, 903, torch.device("cpu"),
                      cfg=dict(tiny_hnerv_cfg), precision=[6, 5, 4, 5, 6],
                      fps_iters=8)
        assert r["metric"] == "hnerv_bunny_network_calib_throughput"
        assert r["unit"] == "iters/sec" and r["card"] == "cpu"
        assert len(r["steady_epoch_rates"]) == 5
        assert r["value"] > 0 and r["decode_fps_per_chip"] > 0

    def test_refuses_without_a_card(self, monkeypatch):
        from neuroquant_tpu_torch import bench

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--iters", "264"])
