"""The port's NQTB codec (coding/codec.py), ``compress`` and
``eval_quantized --from_bitstream`` against the JAX package's, on the CPU.

For the same codes the two packages write byte-identical streams and each
decodes the other's; the native coder equals the pure-Python one; ``compress``
gives the same report; a stream evaluates to the JAX package's PSNR within
1e-3 dB and MS-SSIM within 1e-5, for an AdaRound state (f16 scales, so the
stream is lossless) and for a UAQ state (fp32 scales in the state, f16 in
the stream: another PSNR than the state's)."""

import json
import os
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.coding import codec as jcodec
from neuroquant_tpu.methods import compress as jax_compress
from neuroquant_tpu.methods import eval_quantized as jax_eval
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu.utils.torch_compat import params_to_state_dict, save_pth
from neuroquant_tpu_torch.coding import codec as tcodec
from neuroquant_tpu_torch.methods import compress as port_compress
from neuroquant_tpu_torch.methods import eval_quantized as port_eval

BITS = (6, 5, 4, 5, 6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _synthetic_codes():
    """Three layers: 4-D codes whose C_in columns have unlike statistics
    (the per-column models win: wmode 1), 4-D uniform codes (one per-layer
    model wins: wmode 0), and 2-D codes (always wmode 0)."""
    rng = np.random.RandomState(0)
    skew = np.empty((5, 5, 4, 200), np.int32)
    for c in range(4):
        peak = rng.rand(5, 5, 200) < 0.97
        skew[:, :, c, :] = np.where(peak, c, rng.randint(0, 4, (5, 5, 200)))

    def layer(w, bits, n_b, cw):
        n = w.shape[-1] if cw else 1
        return {"w": w, "b": rng.randint(0, 1 << bits, n_b).astype(np.int32),
                "w_delta": rng.rand(n).astype(np.float32) * 0.01,
                "w_zp": rng.randint(0, 1 << bits, n).astype(np.float32),
                "b_delta": np.float32(0.003), "b_zp": np.float32(7.0),
                "bits": bits}
    return {
        "skewed": layer(skew, 2, 200, True),
        "uniform": layer(rng.randint(0, 16, (3, 3, 8, 6)).astype(np.int32),
                         4, 6, True),
        "flat": layer(rng.randint(0, 64, (24, 10)).astype(np.int32), 6, 10,
                      False),
    }


def _wmode_of_first_layer(stream):
    (nlen,) = struct.unpack_from("<H", stream, 6)
    off = 6 + 2 + nlen + 11
    (ndim,) = struct.unpack_from("<B", stream, off)
    return stream[off + 1 + 4 * ndim]


@pytest.fixture(scope="module")
def model_codes(tiny_hnerv_cfg):
    cfg = dict(tiny_hnerv_cfg)
    model = jax_build_model("hnerv", cfg)
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 80, 160, 3)))
    spec = jax_make_spec("hnerv", cfg, hadamard=True).with_bits(BITS)
    state = jqm.init_quant_state(params, spec)
    return cfg, params, spec, state


class TestCodec:
    def test_native_build_lands_in_the_package(self):
        path = tcodec.build_native()
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(
            tcodec.__file__)))
        assert path.startswith(os.path.join(pkg, "_build", "coder-"))
        assert os.path.exists(path)

    def test_failed_build_raises_with_the_compiler_output(self, tmp_path,
                                                          monkeypatch):
        bad = tmp_path / "range_coder.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(tcodec, "_SRC", str(bad))
        monkeypatch.setattr(tcodec, "_PKG", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tcodec.build_native()

    @pytest.mark.parametrize("n_sym,n", [(4, 300), (64, 2000)])
    def test_native_coder_equals_pure_python(self, n_sym, n):
        rng = np.random.RandomState(n)
        sym = np.minimum(rng.geometric(0.3, n) - 1, n_sym - 1).astype(
            np.int32)
        freqs = tcodec.build_freqs(sym, n_sym)
        np.testing.assert_array_equal(freqs, jcodec.build_freqs(sym, n_sym))
        blob = tcodec.encode_symbols(sym, freqs)
        assert blob == tcodec._py_encode(sym, freqs)
        assert blob == jcodec.encode_symbols(sym, freqs)
        np.testing.assert_array_equal(tcodec.decode_symbols(blob, freqs, n),
                                      sym)
        np.testing.assert_array_equal(tcodec._py_decode(blob, freqs, n), sym)

    def test_streams_are_byte_identical_and_cross_decode(self, model_codes):
        cfg, params, spec, state = model_codes
        ada = jqm.adaround_upgrade(params, spec, state)
        cases = {
            "synthetic": _synthetic_codes(),
            "uaq": _np(jqm.collect_int_codes(params, spec, state,
                                             mode="uaq")),
            "adaround": _np(jqm.collect_int_codes(params, spec, ada,
                                                  mode="adaround")),
        }
        for label, codes in cases.items():
            got = tcodec.compress_artifact(codes)
            want = jcodec.compress_artifact(codes)
            assert got == want, label
            for dec in (tcodec.decompress_artifact(want),
                        jcodec.decompress_artifact(got)):
                assert list(dec) == list(codes)
                for name, c in codes.items():
                    np.testing.assert_array_equal(dec[name]["w"], c["w"])
                    np.testing.assert_array_equal(dec[name]["b"], c["b"])
                    assert dec[name]["bits"] == c["bits"]
                    scales = np.concatenate([
                        np.ravel(c[k]) for k in ("w_delta", "w_zp", "b_delta",
                                                 "b_zp")]).astype(np.float16)
                    np.testing.assert_array_equal(dec[name]["scales"],
                                                  scales.astype(np.float32))

    def test_per_column_and_per_layer_models_both_occur(self):
        codes = _synthetic_codes()
        modes = {name: _wmode_of_first_layer(
            tcodec.compress_artifact({name: c})) for name, c in codes.items()}
        assert modes == {"skewed": 1, "uniform": 0, "flat": 0}

    def test_malformed_streams_raise(self):
        with pytest.raises(ValueError, match="NQTB"):
            tcodec.decompress_artifact(b"XXXX\x02\x00")
        with pytest.raises(ValueError, match="version"):
            tcodec.decompress_artifact(b"NQTB\x09\x00")


def _jax_artifact(cfg, params, spec, state, mode, path, frames):
    model = jax_build_model("hnerv", cfg)
    emb = model.apply(params, jnp.asarray(frames), method="encode")
    artifact = {
        "arch": "hnerv", "mode": mode, "cfg": cfg,
        "state_dict": params_to_state_dict("hnerv", params),
        "quant_spec": {
            "layer_names": spec.layer_names, "layer_paths": spec.layer_paths,
            "n_bits": spec.n_bits, "channel_wise": spec.channel_wise,
            "scale_method": spec.scale_method, "hadamard": spec.hadamard,
            "sym": spec.sym},
        "quant_state": _np(state),
        "int_codes": _np(jqm.collect_int_codes(params, spec, state,
                                               mode=mode)),
        "avg_bits": float(jqm.average_bits(params, spec)),
        "embeddings": np.asarray(emb),
    }
    with open(path, "wb") as f:
        pickle.dump(artifact, f)


def _reports_and_streams(artifact, frame_dir, tmp_path, capsys):
    """Both packages' compress.main on one artifact: (port report, port
    stream path); asserts the reports and the streams agree."""
    jout, tout = str(tmp_path / "jax.nqtb"), str(tmp_path / "port.nqtb")
    argv = ["--artifact", artifact, "--data_path", frame_dir]
    want = jax_compress.main(argv + ["--out", jout])
    got = port_compress.main(argv + ["--out", tout])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(got) == set(want)
    for k in want:
        if k != "bitstream":
            assert got[k] == want[k], k
    assert got["bitstream"] == tout and got["pixels"] == 8 * 80 * 160
    with open(tout + ".json") as f:
        assert json.load(f) == got
    with open(jout, "rb") as f, open(tout, "rb") as g:
        assert f.read() == g.read()
    return got, tout


def _same_metrics(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)


class TestStage4:
    def test_uaq_state_decodes_with_f16_scales(self, model_codes, frame_dir,
                                               tmp_path, capsys):
        """A JAX-written UAQ artifact: the same report and stream from both
        packages' compress; the stream evaluates as in JAX, and not as the
        state does (its fp32 scales are f16 in the stream)."""
        from neuroquant_tpu.data import VideoDataSet

        cfg, params, spec, state = model_codes
        art = str(tmp_path / "uaq.pth")
        frames = np.array(VideoDataSet(cfg, frame_dir).frames)
        _jax_artifact(cfg, params, spec, state, "uaq", art, frames)
        _, stream = _reports_and_streams(art, frame_dir, tmp_path, capsys)
        argv = ["--artifact", art, "--data_path", frame_dir, "--data_split",
                "6_6_8"]
        want = jax_eval.main(argv + ["--from_bitstream", stream])
        got = port_eval.main(argv + ["--from_bitstream", stream, "--device",
                                     "cpu"])
        _same_metrics(got, want)
        from_state = port_eval.main(argv + ["--device", "cpu"])
        _same_metrics(from_state, jax_eval.main(argv))
        # another number, if only in the sixth digit on this untrained
        # model's 10.6 dB
        assert float(got[0]) != float(from_state[0])

    def test_port_written_adaround_artifact(self, model_codes, frame_dir,
                                            tmp_path, capsys, monkeypatch):
        """calibrate_network -> compress -> eval_quantized --from_bitstream
        in the port on the CPU; the JAX package reads the same files to the
        same report and PSNR; an AdaRound state's stream is lossless."""
        import yaml

        from neuroquant_tpu_torch.methods import calibrate_network

        cfg, params, _, _ = model_codes
        monkeypatch.chdir(tmp_path)
        save_pth("ck.pth", "hnerv", params)
        with open("tiny.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        art, state, _ = calibrate_network.main([
            "--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--outf", "t4", "--ckpt", "ck.pth",
            "--precision", *map(str, BITS), "--channel_wise", "--hadamard",
            "--batch_size", "2", "--iters_w", "12", "--data_split", "6_6_8",
            "--fq_impl", "pallas", "--device", "cpu"])
        assert all("w_alpha" in s for s in state.values())
        with open(art, "rb") as f:
            assert "fq_impl" not in pickle.load(f)["quant_spec"]
        capsys.readouterr()
        _, stream = _reports_and_streams(art, frame_dir, tmp_path, capsys)
        argv = ["--artifact", art, "--data_path", frame_dir, "--data_split",
                "6_6_8"]
        got = port_eval.main(argv + ["--from_bitstream", stream, "--device",
                                     "cpu"])
        _same_metrics(got, jax_eval.main(argv + ["--from_bitstream", stream]))
        _same_metrics(got, port_eval.main(argv + ["--device", "cpu"]))

    def test_stream_of_other_codes_is_refused(self, model_codes, frame_dir,
                                              tmp_path):
        from neuroquant_tpu.data import VideoDataSet

        cfg, params, spec, state = model_codes
        art = str(tmp_path / "uaq.pth")
        frames = np.array(VideoDataSet(cfg, frame_dir).frames)
        _jax_artifact(cfg, params, spec, state, "uaq", art, frames)
        with open(art, "rb") as f:
            codes = pickle.load(f)["int_codes"]
        first = next(iter(codes))
        codes[first]["w"] = (codes[first]["w"] + 1) % 2
        stream = str(tmp_path / "other.nqtb")
        with open(stream, "wb") as f:
            f.write(tcodec.compress_artifact(codes))
        with pytest.raises(SystemExit, match="differ from the artifact"):
            port_eval.main(["--artifact", art, "--data_path", frame_dir,
                            "--from_bitstream", stream, "--device", "cpu"])
