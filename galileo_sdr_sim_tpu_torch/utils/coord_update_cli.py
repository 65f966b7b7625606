"""Interactive live-position feeder for the running simulator.

Counterpart of the reference's utils/coord_update_cli.py (pynput
arrow-keys -> velocity integration -> UDP 7533): drives the simulator's
locations port with the same wire format (3 little-endian float64:
lat deg, lon deg, height m).

This version uses raw-terminal WASD/arrow input (no pynput dependency)
and also supports scripted trajectories:

  python -m galileo_sdr_sim_tpu.utils.coord_update_cli                  # interactive
  python -m galileo_sdr_sim_tpu.utils.coord_update_cli --replay path.csv --rate 10

Controls: w/s = north/south velocity, a/d = west/east, r/f = up/down,
space = stop, q = quit.
"""

from __future__ import annotations

import argparse
import select
import socket
import struct
import sys
import time

import numpy as np

EARTH_R = 6371000.0


def send_llh(sock, addr, llh) -> None:
    sock.sendto(struct.pack("<3d", *llh), addr)


def replay(path: str, rate: float, sock, addr) -> None:
    rows = np.loadtxt(path, delimiter=",")
    if rows.ndim == 1:
        rows = rows[None, :]
    for llh in rows:
        send_llh(sock, addr, llh[:3])
        print(f"sent {llh[0]:.6f},{llh[1]:.6f},{llh[2]:.1f}")
        time.sleep(1.0 / rate)


def interactive(llh0, speed: float, rate: float, sock, addr) -> None:
    import termios
    import tty

    llh = np.asarray(llh0, dtype=np.float64).copy()
    vel = np.zeros(3)  # north, east, up [m/s]
    dt = 1.0 / rate

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    print("w/s=N/S a/d=W/E r/f=up/down space=stop q=quit", file=sys.stderr)
    try:
        while True:
            if select.select([sys.stdin], [], [], dt)[0]:
                key = sys.stdin.read(1)
                if key == "q":
                    break
                vel += {
                    "w": [speed, 0, 0], "s": [-speed, 0, 0],
                    "d": [0, speed, 0], "a": [0, -speed, 0],
                    "r": [0, 0, speed], "f": [0, 0, -speed],
                }.get(key, [0, 0, 0])
                if key == " ":
                    vel[:] = 0
            # integrate velocity on the sphere
            llh[0] += np.degrees(vel[0] * dt / EARTH_R)
            llh[1] += np.degrees(vel[1] * dt / (EARTH_R * np.cos(np.radians(llh[0]))))
            llh[2] += vel[2] * dt
            send_llh(sock, addr, llh)
            sys.stderr.write(
                f"\r{llh[0]:.6f},{llh[1]:.6f},{llh[2]:7.1f}  "
                f"v=({vel[0]:.0f},{vel[1]:.0f},{vel[2]:.0f}) m/s   "
            )
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7533)
    p.add_argument("--llh", default="42.3601,-71.0589,100")
    p.add_argument("--speed", type=float, default=5.0, help="m/s per keypress")
    p.add_argument("--rate", type=float, default=10.0, help="updates per second")
    p.add_argument("--replay", help="CSV trajectory lat,lon,hgt to replay")
    args = p.parse_args(argv)

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = (args.host, args.port)
    llh0 = [float(v) for v in args.llh.split(",")]
    if args.replay:
        replay(args.replay, args.rate, sock, addr)
    else:
        interactive(llh0, args.speed, args.rate, sock, addr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
