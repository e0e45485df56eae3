"""Senone bank and checkpoint loading in the PyTorch port vs the JAX
package: the numpy weight converter round-trips a JAX bank exactly, a
JAX checkpoint loads in the port, and the port's ``create_bank`` builds
the same structure (its random means come from a ``torch.Generator``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import ModelConfig
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.train.checkpoint import save_checkpoint
from poccala_tpu.utils.logmath import masked_log as jax_masked_log
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.train.checkpoint import load_checkpoint
from poccala_tpu_torch.utils.errors import ParameterFileError
from poccala_tpu_torch.utils.logmath import NEG_INF, masked_log

torch.set_num_threads(1)

CFG = ModelConfig(state_num=5, mix_level=3, max_mix_level=4)


def jax_bank(units=7, dim=6):
    return jsb.create_bank(units, CFG, dim, key=jax.random.PRNGKey(4))


def jax_arrays(bank):
    return {f: np.asarray(getattr(bank, f)) for f in tsb.FIELDS}


def assert_arrays_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        assert np.array_equal(got[f], want[f]), f


def test_numpy_round_trip_is_exact():
    want = jax_arrays(jax_bank())
    bank = tsb.bank_from_numpy(want, device="cpu")
    assert isinstance(bank, torch.nn.Module)
    assert_arrays_equal(tsb.bank_to_numpy(bank), want)
    assert (bank.num_states, bank.max_mix, bank.dim) == (21, 4, 6)
    assert (bank.num_units, bank.state_num, bank.emit_states) == (7, 5, 3)
    assert bank.senone_id(2, 1) == 7
    assert {n for n, _ in bank.named_buffers()} == set(tsb.FIELDS)


def test_jax_checkpoint_loads(tmp_path):
    jb = jax_bank()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, jb, manifest={"phase": "round", "round": 3},
                    units=["a", "b"], sharded=False)
    bank, manifest = load_checkpoint(path, device="cpu")
    assert_arrays_equal(tsb.bank_to_numpy(bank), jax_arrays(jb))
    with open(f"{path}/manifest.json") as f:
        assert manifest == json.load(f)
    assert manifest["round"] == 3 and manifest["format"] == "npz"


def test_checkpoint_errors(tmp_path):
    with pytest.raises(ParameterFileError):
        load_checkpoint(str(tmp_path), device="cpu")
    (tmp_path / "bank_orbax").mkdir()
    with pytest.raises(ParameterFileError):
        load_checkpoint(str(tmp_path), device="cpu")


@pytest.mark.parametrize("differentiation", [True, False])
def test_create_bank_structure_matches_jax(differentiation):
    jb = jax_arrays(jsb.create_bank(7, CFG, 6, key=jax.random.PRNGKey(0),
                                    differentiation=differentiation))
    gen = torch.Generator().manual_seed(5)
    tb = tsb.bank_to_numpy(tsb.create_bank(7, CFG, 6, generator=gen,
                                           differentiation=differentiation,
                                           device="cpu"))
    for f in ("log_var", "log_w", "log_A", "mix_counts", "senone_map"):
        assert tb[f].dtype == jb[f].dtype and np.array_equal(tb[f], jb[f]), f
    assert np.allclose(tb["log_pi"], jb["log_pi"], rtol=1e-7)
    assert tb["means"].shape == jb["means"].shape
    if differentiation:
        assert ((tb["means"] >= 0) & (tb["means"] < 1)).all()
        again = tsb.create_bank(7, CFG, 6,
                                generator=torch.Generator().manual_seed(5),
                                device="cpu")
        assert np.array_equal(again.means.numpy(), tb["means"])
    else:
        assert np.array_equal(tb["means"], jb["means"])


def test_helpers_match_jax():
    assert np.array_equal(tsb.identity_senone_map(5, 3).numpy(),
                          np.asarray(jsb.identity_senone_map(5, 3)))
    assert np.array_equal(tsb.unit_transmat(5), jsb.unit_transmat(5))
    x = np.array([0.0, 1e-30, 0.5, 2.0, -1.0], np.float32)
    got = masked_log(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_masked_log(jnp.asarray(x)))
    assert np.array_equal(got, want)
    assert got[0] == NEG_INF and np.isfinite(got).all()
