"""Launches of the windowed ops' kernels per frame served in the window:
the kernel modules' `launches` counters, set to 0 as the window opens
(systems/serve_denoise.py), over the window's frames.  Nothing where the
program keeps no such counter."""


def read(run):
    got = run.record.get("launches")
    if not got or not run.record["frames"]:
        return None
    return sum(got.values()) / run.record["frames"]
