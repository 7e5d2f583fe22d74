"""What several per-layer readers share.  Each reader takes a driver's
outcome and returns its number, or None where the run has nothing for it
(then the metric is left out of the result)."""

from portbench import lib


def span_per_gbp(out: dict, field: str):
    """A program span summed over the window's unprofiled jobs, in seconds
    a Gbp of their input."""
    layer = out.get("layer", {})
    jobs = layer.get("jobs", [])[layer.get("profiled", 0):]
    if not jobs:
        return None
    gbp = layer["job_bases"] * len(jobs) / 1e9
    return sum(j[field] for j in jobs) / gbp


def job_rate(out: dict):
    """Input Mbp a second of the window's unprofiled jobs, each over its own
    wall time from the engine's construction to its path files' digest."""
    layer = out.get("layer", {})
    jobs = layer.get("jobs", [])[layer.get("profiled", 0):]
    if not jobs:
        return None
    return layer["job_bases"] * len(jobs) / sum(j["wall_job_s"]
                                                for j in jobs) / 1e6


def roofline(out: dict, bound_key: str, kernels: tuple):
    """100 x (the least time of a profiled unit's launches, times the
    units profiled) / their device time."""
    prof, layer = out.get("profile"), out.get("layer", {})
    if prof is None or layer.get(bound_key) is None:
        return None
    t = lib.kernel_time(prof, *kernels)
    if t <= 0:
        return None
    return 100.0 * layer[bound_key] * layer["profiled"] / t


def idle_pct(out: dict):
    prof = out.get("profile")
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
