"""Passive multicast traffic spy: per-channel and per-drone message rates.

    python -m omniswarm_torch.tools.bus_spy [--port 7667] [--interval 2.0]
        [--duration SECONDS]

Counterpart of ``tools/bus_spy.py`` (the swarm_loop_spy equivalent): joins
the swarm's UDP multicast group through ``runtime/udp_transport.py``,
decodes every packet and prints, every ``--interval`` seconds, the messages
a second on each channel and from each sender. It runs on the host and
takes no device. ``spy`` returns the totals by channel and by sender.
"""
from __future__ import annotations

import argparse
import collections
import time

from omniswarm_torch.runtime.udp_transport import _CHANNELS, UdpMulticastBus


def spy(port: int = 7667, interval: float = 2.0,
        duration: float = 1e9) -> dict:
    """Listen for ``duration`` seconds (or until interrupted), printing the
    rates; returns {"channels": {channel: messages}, "senders": {drone:
    messages}} over the whole run."""
    bus = UdpMulticastBus(port=port)
    counts, senders = collections.Counter(), collections.Counter()
    totals = {"channels": collections.Counter(),
              "senders": collections.Counter()}

    def make_cb(channel):
        def cb(msg):
            counts[channel] += 1
            drone = getattr(msg, "drone_id", getattr(msg, "drone_a", "?"))
            senders[(channel, drone)] += 1
        return cb

    for ch in _CHANNELS:
        bus.subscribe(-1, ch, make_cb(ch))     # spy id -1 hears everyone

    t0 = time.time()
    last_print = t0
    try:
        while time.time() - t0 < duration:
            bus.step()
            now = time.time()
            if now - last_print >= interval:
                window = now - last_print
                lines = [f"--- {time.strftime('%H:%M:%S')} "
                         f"(last {window:.1f}s) ---"]
                for ch in _CHANNELS:
                    n = counts.pop(ch, 0)
                    totals["channels"][ch] += n
                    if n:
                        lines.append(f"  {ch:22s} {n / window:7.1f} msg/s")
                per = collections.Counter()
                for (ch, drone), n in list(senders.items()):
                    per[drone] += n
                    del senders[(ch, drone)]
                totals["senders"].update(per)
                for drone, n in sorted(per.items(), key=str):
                    lines.append(f"  drone {drone}: {n / window:7.1f} msg/s")
                print("\n".join(lines), flush=True)
                last_print = now
            time.sleep(0.02)
    except KeyboardInterrupt:
        pass
    finally:
        bus.close()
    totals["channels"].update(counts)
    for (_, drone), n in senders.items():
        totals["senders"][drone] += n
    return {k: dict(v) for k, v in totals.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m omniswarm_torch.tools.bus_spy",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=7667)
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=1e9)
    args = ap.parse_args(argv)
    return spy(args.port, args.interval, args.duration)


if __name__ == "__main__":
    main()
