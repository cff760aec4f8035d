"""Parity of the port's TOAs host API with the reference: the wideband
DM columns, Flags, select, merge_TOAs, the summary, write_TOA_file, the
``.npz`` cache (save_pickle, load_pickle, get_TOAs(usepickle=)).

Both packages load the reference's own tim fixture
(tests/test_data_layer.py's TIM: GBT and Arecibo rows, ``-fe`` and
``-pn`` flags); the reference runs op by op (``jax.disable_jit``), whose
table the port's equals bit for bit in the tim-derived columns (TDB
within 1 ps and positions within 1e-11 lt-s, test_torch_toas.py's bars).
Every API result is held to the reference's on the same tables: equal
columns, flags, site tables and text.
"""

import os

import numpy as np
import pytest
import torch

import jax

from pint_tpu import toas as jtoas
from pint_tpu_torch import toas as ptoas
from pint_tpu_torch.interop import state_from_numpy
from torch_parity import PAR_WLS, columns_of, params_of

TIM = """FORMAT 1
f1 1400.0 53478.2858714192189005 1.50 gbt -fe Rcvr1_2 -pn 12345
f2 1410.0 53679.8671192734817305 1.20 gbt -fe Rcvr1_2
f3 430.0  53800.1234567890123456 2.10 ao -fe 430
f4 820.0  53900.5000000000000001 0.90 gbt -fe Rcvr_800 -pp_dm 15.9701 -pp_dme 2e-4
"""
DAY = 86400.0


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    p = tmp_path_factory.mktemp("tim") / "t.tim"
    p.write_text(TIM)
    with jax.disable_jit():
        ref = jtoas.get_TOAs(str(p))
    return str(p), ref, ptoas.get_TOAs(str(p), device="cpu")


def assert_same_table(t, ref):
    """The port's table `t` against the reference's `ref`."""
    assert len(t) == len(ref)
    tdb = np.max(np.abs((t.tdb.hi.numpy() - np.asarray(ref.tdb.hi)) * DAY
                        + (t.tdb.lo.numpy() - np.asarray(ref.tdb.lo)) * DAY))
    assert tdb <= 1e-12
    for a, b in ((t.utc.hi, ref.utc.hi), (t.utc.lo, ref.utc.lo),
                 (t.freq_mhz, ref.freq_mhz), (t.error_us, ref.error_us)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t.obs_pos_ls.numpy(), np.asarray(ref.obs_pos_ls),
                               rtol=0, atol=1e-11)
    np.testing.assert_array_equal(t.pulse_number.numpy(),
                                  np.asarray(ref.pulse_number))
    np.testing.assert_array_equal(t.obs_index, np.asarray(ref.obs_index))
    assert t.obs_names == ref.obs_names
    assert list(t.flags) == list(ref.flags)


def test_flags_and_wideband_columns(tables):
    _, ref, t = tables
    assert isinstance(t.flags, ptoas.Flags)
    assert hash(t.flags) == hash(jtoas.Flags(ref.flags))
    for fn in ("get_dm_values", "get_dm_errors"):
        np.testing.assert_array_equal(getattr(t, fn)(), getattr(ref, fn)())
    assert t.is_wideband() == ref.is_wideband() is False
    # parsed once per table; a replaced table parses its own flags
    assert t.get_dm_values() is t.get_dm_values()
    wb = ptoas.Flags(dict(f, pp_dm="15.97", pp_dme="1e-4") for f in t.flags)
    import dataclasses

    t2 = dataclasses.replace(t, flags=wb)
    assert t2.is_wideband() and np.all(t2.get_dm_errors() == 1e-4)


def test_select_matches_reference(tables):
    _, ref, t = tables
    mask = np.asarray([True, False, True, True])
    assert_same_table(t.select(mask), ref.select(mask))
    assert t.select(mask).device == t.device


def test_merge_matches_reference(tables):
    _, ref, t = tables
    ao = np.asarray([False, False, True, False])
    for masks in ((None, ~ao), (ao, ~ao, None)):
        parts = [t if m is None else t.select(m) for m in masks]
        jparts = [ref if m is None else ref.select(m) for m in masks]
        assert_same_table(ptoas.merge_TOAs(parts), jtoas.merge_TOAs(jparts))
    with pytest.raises(ValueError, match="aux columns"):
        import dataclasses

        w = dataclasses.replace(t, aux_columns={"photon_weight": torch.ones(len(t))})
        ptoas.merge_TOAs([t, w])


def test_summary_matches_reference(tables, capsys):
    _, ref, t = tables
    assert t.get_summary() == ref.get_summary()
    t.print_summary()
    assert capsys.readouterr().out == ref.get_summary() + "\n"


def test_write_TOA_file_matches_reference(tables, tmp_path):
    _, ref, t = tables
    text = ptoas.write_TOA_file(t, str(tmp_path / "out.tim"))
    assert text == jtoas.write_TOA_file(ref)
    assert (tmp_path / "out.tim").read_text() == text
    # read back: the MJDs to the format's 20 significant digits
    back = ptoas.get_TOAs(str(tmp_path / "out.tim"), device="cpu")
    gap = ((back.utc.hi - t.utc.hi) + (back.utc.lo - t.utc.lo)).abs().max()
    assert float(gap) < 1e-15 and list(back.flags) == [
        dict(f, name=f"f{i + 1}") for i, f in enumerate(t.flags)]


def test_pickle_roundtrip_matches_reference(tables, tmp_path):
    """save_pickle/load_pickle keep every column bit for bit (aux columns
    too); the reference's load_pickle reads the port's file to the same
    table, and the port reads the reference's."""
    import dataclasses

    _, ref, t = tables
    w = torch.as_tensor([0.5, 0.25, 1.0, 0.75], dtype=torch.float64)
    t = dataclasses.replace(t, aux_columns={"photon_weight": w})
    ptoas.save_pickle(t, str(tmp_path / "p.npz"))
    t2 = ptoas.load_pickle(str(tmp_path / "p.npz"), device="cpu")
    for a, b in ((t2.tdb.hi, t.tdb.hi), (t2.tdb.lo, t.tdb.lo),
                 (t2.obs_pos_ls, t.obs_pos_ls), (t2.obs_vel_c, t.obs_vel_c),
                 (t2.aux_columns["photon_weight"], w)):
        assert torch.equal(a, b)
    assert list(t2.flags) == list(t.flags) and t2.obs_names == t.obs_names
    assert_same_table(t2, jtoas.load_pickle(str(tmp_path / "p.npz")))
    jtoas.save_pickle(ref, str(tmp_path / "r.npz"))
    assert_same_table(ptoas.load_pickle(str(tmp_path / "r.npz"), device="cpu"),
                      ref)


def test_get_toas_usepickle(tables, tmp_path, monkeypatch):
    """usepickle caches in $PINT_TORCH_CACHE_DIR (else beside the tim),
    under the reference's file name, reuses it while it is newer than the
    tim file, and puts a reused table on the caller's device."""
    p = tmp_path / "c.tim"
    p.write_text(TIM)
    cdir = tmp_path / "cache"
    monkeypatch.setenv("PINT_TORCH_CACHE_DIR", str(cdir))
    t1 = ptoas.get_TOAs(str(p), usepickle=True, device="cpu")
    caches = list(cdir.glob("c.tim.*.builtin_analytic.p1c1.npz"))
    assert len(caches) == 1
    loads = []
    real = ptoas.load_pickle
    monkeypatch.setattr(ptoas, "load_pickle",
                        lambda *a, **k: loads.append(a) or real(*a, **k))
    t2 = ptoas.get_TOAs(str(p), usepickle=True, device="cpu")
    assert len(loads) == 1 and torch.equal(t1.tdb.hi, t2.tdb.hi)
    assert t2.device == torch.device("cpu")
    os.utime(p, (os.path.getmtime(p) + 10, os.path.getmtime(p) + 10))
    t3 = ptoas.get_TOAs(str(p), usepickle=True, device="cpu")
    assert len(loads) == 1 and len(t3) == len(t1)
    monkeypatch.delenv("PINT_TORCH_CACHE_DIR")
    ptoas.get_TOAs(str(p), usepickle=True, device="cpu")
    assert len(list(tmp_path.glob("c.tim.*.npz"))) == 1


def test_interop_carries_wideband_and_aux_columns(tables):
    """state_from_numpy carries the wideband DM columns, the aux columns
    and DMEFAC/DMEQUAD/DMJUMP values."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu_torch.models import get_model

    _, ref, _ = tables
    par = PAR_WLS + ("DMEFAC -fe Rcvr1_2 1.3\nDMEQUAD -fe 430 3e-4\n"
                     "DMJUMP -fe Rcvr_800 2e-4 1\n")
    jm = jget_model(par)
    jm["DMEFAC1"].value = 1.25
    jm["DMJUMP1"].value = -3.5e-4
    cols = columns_of(ref)
    vals = np.asarray([15.97, 15.9703, 15.9698, 15.9701])
    cols.update(dm_values=vals, dm_errors=np.full(4, 2e-4),
                aux_columns={"photon_weight": np.linspace(0.1, 0.4, 4)})
    model = get_model(par)
    t = state_from_numpy(params_of(jm), cols, model=model, device="cpu")
    np.testing.assert_array_equal(t.get_dm_values(), vals)
    assert t.is_wideband()
    np.testing.assert_array_equal(t.aux_columns["photon_weight"].numpy(),
                                  np.linspace(0.1, 0.4, 4))
    for k in ("DMEFAC1", "DMEQUAD1", "DMJUMP1"):
        assert model[k].value == (jm[k].hi, jm[k].lo)
