"""The port's FACodec demo CLI (cli/facodec_demo.py) against the JAX
package's on the CPU: both CLIs on one ``.npz`` (``enc/params/...``,
``dec/params/...``, as the JAX demo's ``load_params_npz`` reads it) and 2
WAVs, the two packages' models patched to the small config of
tests/test_torch_facodec.py in both CLIs: the same printed lines, the codes
equal, the reconstructions within one int16 step.

The JAX CLI's templates (its ``init`` before the ``.npz`` replaces every
leaf) come from ``jax.eval_shape`` and its ``apply`` is jitted: eager flax
compiles op by op, and the values it would draw are overwritten."""
import contextlib
import functools
import io

import jax
import numpy as np
import pytest
import torch

from stable_audio_parity import flat, redraw, unflat

import ditsep_tpu.models.facodec as J
import ditsep_tpu_torch.models.facodec as P
from ditsep_tpu_torch.models.weights import params_to_jax
from test_torch_facodec import D, SMALL_DEC, _x

SMALL_ENC = dict(ngf=4, up_ratios=(2, 5), out_channels=D)
WAV_STEP = 1.0 / 32768  # one int16 step of a written WAV


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def shape_template(cls, cfg):
    """A flax module of ``cls`` at ``cfg`` whose ``init`` gives zeros of
    its parameters' shapes (by ``jax.eval_shape``) and whose ``apply`` is
    jitted."""
    class Template(cls):
        def init(self, rngs, *args, **kw):
            shapes = jax.eval_shape(functools.partial(super().init, **kw),
                                    rngs, *args)
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

        def apply(self, variables, *args, **kw):
            return jax.jit(functools.partial(super().apply, **kw))(
                variables, *args)

    return Template(**cfg)


def test_demo_clis_on_one_npz(tmp_path, monkeypatch):
    from ditsep_tpu.cli.facodec_demo import main as jax_main
    from ditsep_tpu_torch.cli.facodec_demo import main as port_main
    from ditsep_tpu_torch.data import read_wav, write_wav

    jenc, jdec = J.FACodecEncoder, J.FACodecDecoder
    monkeypatch.setattr(J, "FACodecEncoder",
                        lambda **kw: shape_template(jenc, SMALL_ENC))
    monkeypatch.setattr(J, "FACodecDecoder",
                        lambda **kw: shape_template(jdec, SMALL_DEC))
    penc, pdec = P.FACodecEncoder, P.FACodecDecoder
    monkeypatch.setattr(P, "FACodecEncoder", lambda **kw: penc(**SMALL_ENC))
    monkeypatch.setattr(P, "FACodecDecoder", lambda **kw: pdec(**SMALL_DEC))
    src_enc, src_dec = P.FACodecEncoder(), P.FACodecDecoder()
    npz = tmp_path / "codec.npz"
    trees = {"enc": redraw({"params": unflat(params_to_jax(src_enc))}, 4),
             "dec": redraw({"params": unflat(params_to_jax(src_dec))}, 5)}
    np.savez(npz, **{f"{side}/{k}": v for side, tree in trees.items()
                     for k, v in flat(tree).items()})
    ind = tmp_path / "in"
    ind.mkdir()
    # one padded length at hop 10 (3,210): one JAX compile
    lengths = {"a.wav": 3210, "b.wav": 3201}
    for i, (name, n) in enumerate(lengths.items()):
        write_wav(str(ind / name), _x((n,), 20 + i), 16000)
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--in-dir", str(ind), "--out-dir", str(tmp_path / name),
                  "--params", str(npz), "--cpu"])
        outs[name] = buf.getvalue().splitlines()
    assert outs["port"][:2] == outs["jax"]
    for name, n in lengths.items():
        stem = name[:-4]
        codes = {k: np.load(tmp_path / k / f"{stem}_codes.npy")
                 for k in outs}
        assert codes["port"].dtype == codes["jax"].dtype
        assert np.array_equal(codes["port"], codes["jax"])
        assert codes["port"].shape == (-(-n // 10), 6)
        recs = {k: read_wav(str(tmp_path / k / f"{stem}_reconstructed.wav"))
                for k in outs}
        assert recs["port"][1] == recs["jax"][1] == 16000
        assert recs["port"][0].shape == recs["jax"][0].shape == (n,)
        assert np.abs(recs["port"][0] - recs["jax"][0]).max() <= WAV_STEP
