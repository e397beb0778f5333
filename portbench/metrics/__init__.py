"""Per-layer metric readers: `<metric>.py` holds `read(data)`, which
returns the metric's value from the traced run's data, or None when
there is nothing to read.  `data` holds `calls` (per timed call, the
program's stage marks as {stage: ms}), `times`, `window_s`, `device`
(the device trace's `busy_s` and `window_s`, or None) and what the
cell's driver adds (`work`)."""


def stage_mean(data: dict, stages) -> float:
    """Mean over the applies of the summed milliseconds of `stages`, or
    None where no apply recorded them."""
    vals = [sum(a[s] for s in stages) for call in data.get("calls", [])
            for a in call if all(s in a for s in stages)]
    return sum(vals) / len(vals) if vals else None


def idle_share(data: dict) -> float:
    """Percent of the traced window in which no operation ran on the
    card, or None without a device trace."""
    d = data.get("device")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
