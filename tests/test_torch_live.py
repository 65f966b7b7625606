"""Interactive (live) mode at B = 1 through the port's UdpServers and
streaming executor on the CPU: the reference's latency contract
(galileo-sdr.cpp:443, its 0.2 s FIFO) as tests/test_baseline_configs.py
pins it for the JAX package.  A UDP position update sent while block k
drains must reach the emitted samples of block k + 2: PCPS acquisition
on the samples recovers the transmitted code phase, which the ~110 km
move shifts by tens of chips."""

from galileo_sdr_sim_tpu_torch.harness import free_udp_ports, live_pickup

from _torch_parity import CPU, NAV


def test_live_position_reaches_samples_b1():
    got = live_pickup(NAV, CPU, free_udp_ports(3))
    assert got["blocks"] >= 4, got
    # block 1, before the move: acquisition finds the transmitted phase
    assert got["metric1"] > 8.0 and got["err1_chips"] < 1.0, got
    # block 3 already carries the moved position; the move's Doppler jump
    # sends it through the direct fallback, whose samples stay bounded
    assert got["moved3_chips"] > 20.0, got
    assert got["fallback_blocks"] >= 1 and got["rms3"] < 2000.0, got
    # block 4: the samples hold the moved geometry, far from the unmoved
    assert got["metric4"] > 8.0 and got["err4_chips"] < 1.0, got
    assert got["from_stay4_chips"] > 20.0, got
    assert got["ok"]
