"""Command line of the PyTorch port: the reference simulator's flags plus
`--device` (default cuda).

    python -m galileo_sdr_sim_tpu_torch.cli -e NAV -U 1 -b 1 -o out.ishort

Its parser and helpers are a copy of the JAX package's
(galileo_sdr_sim_tpu/cli.py:47-208: the same flags and defaults), and it
follows that package's `cli.main`: `--engine auto|kp_pallas|kp` runs the
factorized engine (the CUDA kernel on a GPU, its plain PyTorch version on
the CPU) and `--engine direct` the direct engine; `--model cboc`,
`--apply-gain` and `--bandlimit` (which implies `--model cboc`) run as
in the JAX package.  With GALILEO_COORDINATOR, GALILEO_NUM_PROCESSES and
GALILEO_PROCESS_ID set on every process, the same command line writes the
file cooperatively (parallel/distributed.py): NCCL and the kernel under
`--device cuda`, one process per GPU; gloo and the plain versions under
`--device cpu`.  `--pipeline-depth N` and `--checkpoint FILE` reach the
streaming executor as in the JAX CLI; as there, the file sink opens its
output with "wb", so a run resumed from a checkpoint rewrites the file
from the resumed epoch.  Without `-U` the samples go to the radio as in
the JAX CLI (galileo_sdr_sim_tpu/cli.py:349-357): the device drain
writes the native C++ ring (0.2 s deep, FIFO_LENGTH), whose consumer
thread hands SAMPLES_PER_BUFFER chunks to `UsrpSink` (the `uhd`
package).  `--trace-dir DIR` runs the stream under torch.profiler and
writes a TensorBoard-loadable trace to DIR (profiling.trace).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from dataclasses import dataclass

import numpy as np

from .constants import R2D
from .device import resolve_device
from .gnss_time import DateTime, GalTime, date2gal
from .parallel.distributed import ENV_COORD
from .rinex import read_rinex_v3
from .scenario import PositionProvider, ScenarioEngine, scenario_start_time


def _parse_time(s: str) -> GalTime:
    import re

    m = re.match(r"(\d+)/(\d+)/(\d+),(\d+):(\d+):([\d.]+)", s)
    if not m:
        raise SystemExit("ERROR: Invalid date and time.")
    y, mo, d, hh, mm = (int(m.group(i)) for i in range(1, 6))
    sec = float(m.group(6))
    if (
        y <= 1980 or not 1 <= mo <= 12 or not 1 <= d <= 31
        or not 0 <= hh <= 23 or not 0 <= mm <= 59 or not 0 <= sec < 60
    ):
        raise SystemExit("ERROR: Invalid date and time.")
    return date2gal(DateTime(y, mo, d, hh, mm, float(int(sec))))


def load_user_motion(path: str) -> np.ndarray:
    """User-motion file -> (N, 3) llh degrees at 10 Hz."""
    from .geodesy import xyz2llh

    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64)
    if arr.shape[1] == 3:  # lat, lon, hgt (deg)
        return arr
    if arr.shape[1] == 4:  # time, x, y, z ECEF (gps-sdr-sim style)
        llh = xyz2llh(arr[:, 1:4])
        return np.stack([llh[:, 0] * R2D, llh[:, 1] * R2D, llh[:, 2]], axis=-1)
    raise SystemExit(f"ERROR: unrecognized user-motion format in {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="galileo-sdr-torch",
        description="Galileo E1 OS baseband signal simulator (PyTorch/CUDA port)",
    )
    p.add_argument("-e", dest="navfile", metavar="RINEX", help="RINEX nav file")
    p.add_argument("-n", dest="tvfile", metavar="TV", help="(vestigial) test-vector file")
    p.add_argument("-o", dest="outfile", metavar="FILE", default="galileosim.ishort")
    p.add_argument("-l", dest="llh", metavar="LAT,LON,HGT", default="42.3601,-71.0589,2")
    p.add_argument("-t", dest="start", metavar="Y/M/D,h:m:s")
    p.add_argument("-T", dest="overwrite", metavar="Y/M/D,h:m:s|now")
    p.add_argument("-d", dest="duration", type=float, default=300.0)
    p.add_argument("-G", dest="gain", type=float, default=30.0)
    p.add_argument("-a", dest="device_args", default="")
    p.add_argument("-p", dest="udp_port", type=int, default=5671)
    p.add_argument("-i", dest="interactive", action="store_true")
    p.add_argument("-I", dest="iono_disable", action="store_true")
    p.add_argument("-U", dest="disable_usrp", nargs="?", const="1", default=None)
    p.add_argument("-b", dest="disable_bitstream", nargs="?", const="1", default=None)
    p.add_argument("-v", dest="verbose", action="store_true")
    p.add_argument("-u", dest="umfile", metavar="FILE", help="user-motion file")
    p.add_argument("--mode", choices=("float", "lut512"), default="float")
    p.add_argument("--model", choices=("e1", "cboc"), default="e1",
                   help="signal model: sine-BOC(1,1) E1 OS (reference "
                        "parity, default) or full CBOC(6,1,1/11) "
                        "(models/cboc.py; same fused-kernel rate)")
    p.add_argument("--engine", choices=("auto", "kp_pallas", "kp", "direct"),
                   default="auto",
                   help="synthesis engine: 'auto', 'kp_pallas' and 'kp' = "
                        "the factorized (K,p) engine (the CUDA kernel on a "
                        "GPU, its plain PyTorch version on the CPU); "
                        "'direct' = the direct reference formulation")
    p.add_argument("--block-epochs", type=int, default=None,
                   help="epochs per device call (default 8; 1 when -i for "
                        "low-latency live position updates)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="device blocks in flight ahead of the sink "
                        "(default 1: single-thread prep-then-drain, which "
                        "measures fastest and keeps the one-epoch live-"
                        "position latency; >=2 adds a producer thread)")
    p.add_argument("--checkpoint", metavar="FILE",
                   help="snapshot scenario state every 30 s; resumes "
                        "automatically if the file exists")
    p.add_argument("--dummy-almanac", action="store_true",
                   help="emit dummy word 63 in the almanac slots (word "
                        "types 7-10) like the reference instead of real "
                        "almanac data derived from the ephemerides")
    p.add_argument("--bandlimit", action="store_true",
                   help="emit the band-limited CBOC stream (synthesize "
                        "at 12x via polyphase fused-kernel calls, "
                        "low-pass at 1.3 MHz, decimate — what a band-"
                        "limited front end digitizes; implies --model "
                        "cboc; ops/bandlimit.py)")
    p.add_argument("--apply-gain", action="store_true",
                   help="apply per-channel path-loss/antenna gain to the mix "
                        "(the reference computes but does not apply it)")
    p.add_argument("--relay-timeout", type=float, default=None, metavar="SEC",
                   help="in bit-relay mode, fall back to ephemeris-"
                        "synthesized nav messages if no bits arrive on UDP "
                        "7531 within SEC seconds (default: wait forever, "
                        "like the reference, galileo-sdr.cpp:389-416)")
    p.add_argument("--noise-cn0", type=float, default=None, metavar="DBHZ",
                   help="add calibrated AWGN to the output for a target "
                        "per-component C/N0 [dB-Hz] (noise.py; emulates "
                        "the over-the-air channel of the reference's "
                        "hardware-receiver validation)")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="write a torch.profiler trace of the run (host "
                        "and, on a GPU, device) to DIR (TensorBoard-"
                        "loadable; profiling.trace)")
    p.add_argument("--native-fifo", action="store_true",
                   help="route the file sink through the native C++ ring "
                        "buffer + consumer thread (always on for USRP "
                        "output, mirroring the reference's FIFO + tx_task)")
    return p


def _status_printer(engine: ScenarioEngine, g0: GalTime):
    def cb(batch, stats):
        rows = []
        for i, ch in enumerate(engine.bank.channels):
            if ch.prn <= 0:
                continue
            rows.append(
                f"{i:3d}{ch.prn:6d}{ch.azel[0]*R2D:14.6f}{ch.azel[1]*R2D:17.6f}"
                f"{ch.f_carr:21.6f}{ch.code_phase:18.6f}{engine.grx.sec:18.6f}"
                f"{ch.rho0_range:18.6f}{ch.eph_index:5d}"
            )
        sys.stderr.write("\x1b[2J\x1b[H")
        sys.stderr.write(
            f" Elapsed {engine.grx - g0:6.1f} s | {stats.realtime_factor:8.1f}x realtime\n"
        )
        sys.stderr.write(
            f"{'CH':>3}{'PRN':>6}{'Azimuth':>14}{'Elevation':>17}"
            f"{'Doppler [Hz]':>21}{'Code phase':>18}{'rx_time':>18}"
            f"{'Pseudorange':>18}{'Eph':>5}\n"
        )
        sys.stderr.write("\n".join(rows) + "\n")

    return cb


# short options that take a value and may legitimately receive one
# starting with '-' (negative latitude/longitude): getopt accepts
# "-l -6,51,100" (the README's canonical example, README.md:49-60) but
# argparse would parse "-6,51,100" as an option — glue the pair together
# into argparse's attached short-option form.
_VALUE_OPTS = {"-l", "-t", "-T", "-d", "-G"}


def _glue_negative_values(argv: list[str]) -> list[str]:
    out, i = [], 0
    while i < len(argv):
        tok = argv[i]
        if (
            tok in _VALUE_OPTS
            and i + 1 < len(argv)
            and argv[i + 1][:1] == "-"
            and len(argv[i + 1]) > 1
            and argv[i + 1][1].isdigit()
        ):
            out.append(tok + argv[i + 1])
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def build_torch_parser():
    p = build_parser()
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; fails without a GPU) "
                        "or 'cpu' (the plain PyTorch engines)")
    return p


@dataclass
class Run:
    """A configured run: call synth.run(), then close(), which drains
    and closes the sink (the radio's ring first) and stops the servers."""

    synth: object  # io.stream.StreamingSynthesizer
    sink: object
    servers: object | None  # io.udp.UdpServers of the live position

    def close(self) -> None:
        self.sink.close()
        if self.servers is not None:
            self.servers.stop()


def _refuse_unported(args) -> str | None:
    if os.environ.get(ENV_COORD) and args.disable_usrp is None:
        return "ERROR: distributed mode supports the file sink only (-U 1)."
    return None


def build_engine(args) -> tuple:
    """Nav data, start time, position source, bit relay and scenario
    engine -> (engine, the live-position UdpServers or None); the caller
    stops the servers."""
    nav = read_rinex_v3(args.navfile)
    if args.iono_disable:
        nav.iono.enable = False
    if args.dummy_almanac:
        nav.dummy_almanac = True

    g0 = None
    timeoverwrite = False
    if args.overwrite:
        timeoverwrite = True
        if args.overwrite.startswith("now"):
            import datetime as _dt

            now = _dt.datetime.now(_dt.timezone.utc)
            g0 = date2gal(DateTime(now.year, now.month, now.day, now.hour,
                                   now.minute, float(now.second)))
        else:
            g0 = _parse_time(args.overwrite)
    elif args.start:
        g0 = _parse_time(args.start)
    g0 = scenario_start_time(nav, g0, timeoverwrite=timeoverwrite)

    llh0 = np.array([float(v) for v in args.llh.split(",")])

    servers = None
    if args.interactive or args.umfile is None:
        # the reference always spawns the locations thread (galileo-sdr.cpp:185)
        from .io.udp import UdpServers

        servers = UdpServers(llh0).start()
        position = PositionProvider(live=lambda: servers.state.llh)
    if args.umfile:
        position = PositionProvider(trajectory=load_user_motion(args.umfile))

    try:
        bit_source = None
        if args.disable_bitstream is None and servers is not None:
            bit_source = _wait_for_bits(servers, args.relay_timeout)

        if args.bandlimit:
            args.model = "cboc"
        if args.model == "cboc":
            from .models.cboc import E1_CBOC as signal_model
        else:
            from .models.e1 import E1_OS as signal_model
        engine = ScenarioEngine(nav, position, g0, args.duration,
                                verbose=args.verbose, bit_source=bit_source,
                                model=signal_model)
    except BaseException:
        if servers is not None:
            servers.stop()
        raise
    return engine, servers


def build_run(args) -> Run:
    """Everything `main` sets up before synthesis: the scenario engine
    (`build_engine`), sink and executor."""
    device = resolve_device(args.device)
    engine, servers = build_engine(args)
    try:
        from .io.sinks import FileSink, UsrpSink
        from .io.stream import StreamingSynthesizer

        if args.disable_usrp is None:
            # real-time path: device drain -> native C++ ring (0.2 s deep,
            # FIFO_LENGTH) -> consumer thread -> UHD, the reference's
            # galileo_task/tx_task split
            from .io.native_fifo import ThreadedRingSink

            sink = ThreadedRingSink(UsrpSink(gain=args.gain, device_args=args.device_args))
        elif args.native_fifo:
            from .io.native_fifo import NativeFifoSink

            sink = NativeFifoSink(args.outfile)
        else:
            sink = FileSink(args.outfile)
        try:
            if args.noise_cn0 is not None:
                from .noise import AwgnSink

                sink = AwgnSink(sink, args.noise_cn0)
            status_cb = _status_printer(engine, engine.g0) if args.verbose else None
            block_epochs = args.block_epochs or (1 if args.interactive else 8)
            synth = StreamingSynthesizer(
                engine, sink, device=device, mode=args.mode,
                synth_engine=args.engine, block_epochs=block_epochs,
                status_cb=status_cb, checkpoint_path=args.checkpoint,
                apply_gain=args.apply_gain, pipeline_depth=args.pipeline_depth,
                bandlimit=args.bandlimit,
            )
        except BaseException:
            sink.close()
            raise
    except BaseException:
        if servers is not None:
            servers.stop()
        raise
    return Run(synth, sink, servers)


def _wait_for_bits(servers, relay_timeout: float | None):
    """Live nav-bit relay: wait for the first bits like the reference
    (galileo-sdr.cpp:389-416), with an optional timeout fallback."""
    import time as _time

    sys.stderr.write("\nWaiting for navigation message bits ")
    t0 = _time.monotonic()
    while not servers.state.bit_queues:
        if relay_timeout is not None and _time.monotonic() - t0 > relay_timeout:
            sys.stderr.write(
                "\nNo bits received - generating nav messages from ephemeris data\n"
            )
            break
        _time.sleep(1.0)
        sys.stderr.write(".")
    else:
        sys.stderr.write("\nBits received - Starting Generator\n")
    return servers.state


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = build_torch_parser().parse_args(_glue_negative_values(list(argv)))

    if not args.navfile and not args.tvfile:
        print("ERROR: Galileo ephemeris/nav_msg file is not specified.")
        return 1
    if args.tvfile and not args.navfile:
        print("ERROR: test-vector replay (-n) is vestigial in the reference "
              "and not supported; provide a RINEX file with -e.")
        return 1
    refusal = _refuse_unported(args)
    if refusal:
        print(refusal)
        return 1
    if os.environ.get(ENV_COORD):
        return _main_distributed(args)

    run = build_run(args)

    def _sigint(signum, frame):
        sys.stderr.write("\nDone\n")
        run.synth.stop()

    previous = signal.signal(signal.SIGINT, _sigint)
    try:
        if args.trace_dir:
            from .profiling import trace

            with trace(args.trace_dir, run.synth.device):
                stats = run.synth.run()
        else:
            stats = run.synth.run()
    finally:
        signal.signal(signal.SIGINT, previous)
        run.close()

    sys.stderr.write(
        f"\nDone! {stats.epochs} epochs, {stats.samples} samples, "
        f"{stats.wall_s:.1f} s wall ({stats.realtime_factor:.1f}x realtime)\n"
    )
    if args.verbose:
        sys.stderr.write(stats.stage_report() + "\n")
    return 0


def _main_distributed(args) -> int:
    """Multi-process file generation (galileo_sdr_sim_tpu/cli.py:326-344):
    join the group the environment names, write this process's share of
    the file, leave the group.  As in the JAX package, --apply-gain and
    --bandlimit are not applied in this mode."""
    from torch import distributed as dist

    from .parallel.distributed import generate_file_distributed, maybe_initialize_from_env

    device = resolve_device(args.device)
    maybe_initialize_from_env("gloo" if device.type == "cpu" else "nccl")
    try:
        engine, servers = build_engine(args)
        try:
            t0 = time.monotonic()
            n = generate_file_distributed(
                engine, args.outfile, block_epochs=args.block_epochs or 8,
                device_type=device.type,
            )
            wall = time.monotonic() - t0
        finally:
            if servers is not None:
                servers.stop()
    finally:
        dist.destroy_process_group()
    sys.stderr.write(f"\nDone! {n} epochs written cooperatively in {wall:.1f} s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
