"""The port's checkpoints (utils/checkpoint.py) and the smoothers' per-sweep
resume, on the CPU.

Format: a structure saved by either package loads in the other with equal
values, and both write the same npz keys (``jax.tree_util.keystr`` of each
leaf's path); bfloat16 leaves travel as their uint16 bits.

Resume: as tests/test_checkpoint.py:21-48, a smoother run with
``checkpoint_dir`` for fewer sweeps and then called again for all of them
equals an unbroken run bit for bit (``torch.equal`` on every field), for
run_rbps on the radio problem (2 sweeps, then 4) and on the sparse toy
(2, then 3) and for run_rbps_information_form on the mag3d problem (2,
then 3); once with a generator (the resumed call's own generator is
seeded differently: its state comes from the checkpoint) and once with
JAX's draws injected, where the resumed run also matches the JAX package's
unbroken run at the smoother tests' tolerances (XNK atol 1e-4, XLK atol
1e-3, PK 1e-3 of its scale, ess rtol 1e-3, retry counts equal).
"""

from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rbslam_tpu.engines import RBPSConfig as JSConfig  # noqa: E402
from rbslam_tpu.engines import run_rbps as jrun_rbps  # noqa: E402
from rbslam_tpu.engines import (  # noqa: E402
    run_rbps_information_form as jrun_info,
)
from rbslam_tpu.utils import checkpoint as jckpt  # noqa: E402
from rbslam_tpu_torch.engines import (  # noqa: E402
    RBPSConfig,
    run_rbps,
    run_rbps_information_form,
)
from rbslam_tpu_torch.utils import (  # noqa: E402
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

import test_torch_radio as radio_tests  # noqa: E402
import test_torch_smoothers as smoother_tests  # noqa: E402
import test_torch_sparse as sparse_tests  # noqa: E402
from test_torch_radio import radio  # noqa: E402,F401  (fixture)
from test_torch_smoothers import mag, mag_noise  # noqa: E402,F401
from test_torch_sparse import toy  # noqa: E402,F401  (fixture)


class Pair(NamedTuple):
    a: object
    b: object


def _tree(lib):
    """One structure of every container kind, built from numpy with
    ``lib``'s array constructor."""
    rng = np.random.default_rng(0)
    return {
        "x": lib(rng.normal(size=(2, 3)).astype(np.float32)),
        "n": {"i": lib(np.arange(5, dtype=np.int32)),
              "j": [lib(np.array([True, False])),
                    lib(np.array(7, dtype=np.int32))]},
        "p": Pair(a=lib(rng.normal(size=(4,)).astype(np.float32)),
                  b=(lib(np.ones((1, 2), np.float32)),)),
    }


def _leaves_np(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda v: isinstance(v, torch.Tensor))]


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree(torch.tensor)
    tree["k"] = torch.arange(3)                        # int64
    path = save_checkpoint(str(tmp_path), 3, tree)
    assert path.endswith("ckpt_3.npz")
    save_checkpoint(str(tmp_path), 1, tree)
    assert latest_step(str(tmp_path)) == 3
    back = load_checkpoint(str(tmp_path), 3, tree)
    assert isinstance(back["p"], Pair) and isinstance(back["n"]["j"], list)
    assert isinstance(back["p"].b, tuple)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(tree)):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_interchange_with_jax(tmp_path, writer):
    """A structure saved by one package loads in the other with equal
    values; both write the same keys."""
    port_tree, jax_tree = _tree(torch.tensor), _tree(jnp.asarray)
    if writer == "port":
        save_checkpoint(str(tmp_path), 2, port_tree)
        back = jckpt.load_checkpoint(str(tmp_path), 2, jax_tree)
    else:
        jckpt.save_checkpoint(str(tmp_path), 2, jax_tree)
        back = load_checkpoint(str(tmp_path), 2, port_tree)
        assert all(isinstance(v, torch.Tensor)
                   for v in jax.tree_util.tree_leaves(back))
    assert jckpt.latest_step(str(tmp_path)) == latest_step(str(tmp_path)) == 2
    for got, want in zip(_leaves_np(back), _leaves_np(jax_tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with np.load(tmp_path / "ckpt_2.npz") as data:
        keys = set(data.files)
    assert keys == set(jckpt._flatten(jax_tree))
    assert keys == {"['x']", "['n']['i']", "['n']['j'][0]", "['n']['j'][1]",
                    "['p'].a", "['p'].b[0]"}


def test_bfloat16_leaves(tmp_path):
    """A bfloat16 tensor is stored as its uint16 bits and comes back
    bit-equal with its dtype from ``like``; another ``like`` dtype is
    refused, never cast."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"x": x, "y": x.float()})
    with np.load(tmp_path / "ckpt_1.npz") as data:
        assert data["['x']"].dtype == np.uint16
        np.testing.assert_array_equal(
            data["['x']"], x.view(torch.int16).numpy().view(np.uint16))
    back = load_checkpoint(str(tmp_path), 1, {"x": x, "y": x.float()})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    with pytest.raises(ValueError, match="uint16"):
        load_checkpoint(str(tmp_path), 1, {"x": x.float(), "y": x})
    with pytest.raises(ValueError, match="has no leaf"):
        load_checkpoint(str(tmp_path), 1, {"z": x})


def test_latest_step_empty_or_missing(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    (tmp_path / "ckpt_x.npz").write_bytes(b"")
    (tmp_path / "notes.txt").write_text("no checkpoint")
    assert latest_step(str(tmp_path)) is None


# --- per-sweep resume of the smoothers ---------------------------------------

def _radio_case(fixtures):
    r = fixtures["radio"]
    key = jax.random.PRNGKey(radio_tests.SEED)
    n_p, T = radio_tests.N_P, radio_tests.T_STEPS

    def noise(n_sweeps):
        return smoother_tests.smoother_noise(key, n_sweeps, T, n_p, 1,
                                             "multinomial", info_form=False)

    return dict(fn=run_rbps, args=r["prob"].rbpf_args(), cfg={"n_particles":
                n_p}, sweeps=(2, 4), noise=noise,
                ref=lambda n: jrun_rbps(key, *r["jargs"],
                                        JSConfig(n_particles=n_p,
                                                 n_sweeps=n)))


def _sparse_case(fixtures):
    toy_ = fixtures["toy"]
    key = jax.random.PRNGKey(6)
    n_p = sparse_tests.N_PS

    def noise(n_sweeps):
        return sparse_tests.smoother_noise(key, n_sweeps, sparse_tests.T_TOY,
                                           n_p)

    return dict(fn=run_rbps, args=sparse_tests._args(toy_, n_p, False),
                cfg={"n_particles": n_p}, sweeps=(2, 3), noise=noise,
                ref=lambda n: jrun_rbps(key,
                                        *sparse_tests._args(toy_, n_p, True),
                                        JSConfig(n_particles=n_p,
                                                 n_sweeps=n)))


def _info_case(fixtures):
    m = fixtures["mag"]
    n_p = smoother_tests.N_P
    cfg = {"n_particles": n_p, "resampling": "systematic"}

    def noise(n_sweeps):
        return tuple(a[:n_sweeps] for a in fixtures["mag_noise"])

    return dict(fn=run_rbps_information_form, args=m["prob"].rbpf_args(),
                cfg=cfg, sweeps=(2, 3), noise=noise,
                ref=lambda n: jrun_info(jax.random.PRNGKey(0), *m["jargs"],
                                        JSConfig(n_sweeps=n, **cfg)))


CASES = {"radio_cpf_as": (_radio_case, ("radio",)),
         "sparse_cpf_as": (_sparse_case, ("toy",)),
         "mag3d_info_form": (_info_case, ("mag", "mag_noise"))}


@pytest.mark.parametrize("draws", ["generator", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_equals_unbroken(request, tmp_path, case, draws):
    build, needs = CASES[case]
    c = build({name: request.getfixturevalue(name) for name in needs})
    first, total = c["sweeps"]

    def call(n_sweeps, seed, **kw):
        if draws == "jax":
            kw["noise"] = c["noise"](n_sweeps)
            gen = None
        else:
            gen = torch.Generator().manual_seed(seed)
        return c["fn"](*c["args"], RBPSConfig(n_sweeps=n_sweeps, **c["cfg"]),
                       generator=gen, device="cpu", **kw)

    full = call(total, 5)
    ck = str(tmp_path / "ck")
    part = call(first, 5, checkpoint_dir=ck)
    assert latest_step(ck) == first
    resumed = call(total, 99, checkpoint_dir=ck)
    assert latest_step(ck) == total
    for field, a, b in zip(full._fields, full, resumed):
        assert a.dtype == b.dtype and torch.equal(a, b), field
    assert torch.equal(part.XNK, full.XNK[:first])
    # a checkpoint at the full count: the call returns it without a sweep
    again = call(total, 123, checkpoint_dir=ck)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    if draws == "jax":
        smoother_tests.assert_smoothers_match(resumed, c["ref"](total))
