"""Command line of the PyTorch port: the reference simulator's flags plus
`--device` (default cuda).

    python -m galileo_sdr_sim_tpu_torch.cli -e NAV -U 1 -b 1 -o out.ishort

Reuses the JAX package's JAX-free parser and helpers and follows its
`cli.main` for the file sink: `--engine auto|kp_pallas|kp` runs the
factorized engine (the CUDA kernel on a GPU, its plain PyTorch version on
the CPU) and `--engine direct` the direct engine; `--model cboc`,
`--apply-gain` and `--bandlimit` (which implies `--model cboc`) run as
in the JAX package.  With GALILEO_COORDINATOR, GALILEO_NUM_PROCESSES and
GALILEO_PROCESS_ID set on every process, the same command line writes the
file cooperatively (parallel/distributed.py): NCCL and the kernel under
`--device cuda`, one process per GPU; gloo and the plain versions under
`--device cpu`.  The USRP sink, --trace-dir and the options listed in
io/stream.py are not ported yet and stop with an error naming their
ROADMAP item.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from dataclasses import dataclass

import numpy as np

from galileo_sdr_sim_tpu.cli import (
    _glue_negative_values,
    _parse_time,
    _status_printer,
    build_parser,
    load_user_motion,
)
from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
from galileo_sdr_sim_tpu.parallel.distributed import ENV_COORD
from galileo_sdr_sim_tpu.rinex import read_rinex_v3
from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine, scenario_start_time

from .device import resolve_device


def build_torch_parser():
    p = build_parser()
    p.prog = "galileo-sdr-torch"
    p.description = "Galileo E1 OS baseband signal simulator (PyTorch/CUDA port)"
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; fails without a GPU) "
                        "or 'cpu' (the plain PyTorch engines)")
    return p


@dataclass
class Run:
    """A configured file-sink run: call synth.run(), then close()."""

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
    if args.disable_usrp is None:
        return ("ERROR: the USRP sink is not ported to the PyTorch engine yet "
                "(ROADMAP queue 1 item 6); use the file sink (-U 1).")
    if args.trace_dir:
        return ("ERROR: --trace-dir is not ported to the PyTorch engine yet "
                "(ROADMAP queue 1 item 12).")
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
        from galileo_sdr_sim_tpu.io.udp import UdpServers

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
            from galileo_sdr_sim_tpu.models.cboc import E1_CBOC as signal_model
        else:
            from galileo_sdr_sim_tpu.models.e1 import E1_OS as signal_model
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
        from galileo_sdr_sim_tpu.io.sinks import FileSink

        from .io.stream import StreamingSynthesizer

        if args.native_fifo:
            from galileo_sdr_sim_tpu.io.native_fifo import NativeFifoSink

            sink = NativeFifoSink(args.outfile)
        else:
            sink = FileSink(args.outfile)
        try:
            if args.noise_cn0 is not None:
                from galileo_sdr_sim_tpu.noise import AwgnSink

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
