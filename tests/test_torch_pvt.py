"""The parity bar's acceptance tier on the CPU: a 19 s stream that the
port's CLI makes (`--device cpu`, the plain engines) of the fixture
nav file's scene at Boston from 2022-02-19 23:30:18 gives the in-repo
receiver's PVT fix (rx_pvt.receiver_fix, the port's copy: acquisition,
tracking, I/NAV decode, least squares from the samples alone, the
scene's PRNs as candidates).  The bars are the JAX package's
(tests/test_e2e_pvt.py): at least 5 satellites, under 15 m from the
truth, and the receive time within 1e-5 s of the transmitter's epoch
clock.  The scene starts at tow 603018, 18 mod 30, so that every
ephemeris word type is on the air within 19 s."""

import pytest

from galileo_sdr_sim_tpu_torch import cli
from galileo_sdr_sim_tpu_torch.harness import PVT_SECONDS, PVT_START, pvt_fix

from _torch_parity import LLH, NAV


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pvt")
    um = tmp / "static.csv"  # a one-row user-motion file: no UDP port
    um.write_text(",".join(str(v) for v in LLH) + "\n")
    out = tmp / "pvt.ishort"
    rc = cli.main(["-e", str(NAV), "-U", "1", "-b", "1", "-t", PVT_START, "-d", str(PVT_SECONDS),
                   "-l", ",".join(str(v) for v in LLH), "-o", str(out), "--device", "cpu",
                   "-u", str(um)])
    assert rc == 0
    assert out.stat().st_size == 189 * 260000 * 4
    return pvt_fix(out, NAV)


def test_fix_uses_at_least_five_satellites(fix):
    assert fix["n_sats"] >= 5, fix
    assert set(fix["fix_prns"]) <= set(fix["prns"])


def test_fix_within_15_m(fix):
    assert fix["err_m"] < 15.0, fix
    assert fix["max_residual_m"] < 8.0, fix


def test_receive_time_recovered(fix):
    assert fix["t_rx_err_s"] < 1e-5, fix
