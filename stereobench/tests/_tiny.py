"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test run holds."""

from __future__ import annotations

from stereobench import harness

# Image size and batch of each route's tiny cells; the SGM route at 32
# disparities (the int8 volume's storage, as at 256).
TINY = {"classic": {"height": 40, "width": 72}, "sgm": {"height": 36, "width": 64}}
SGM_DISPARITIES = 32


def tiny_cell(name: str, batch=None, **traffic):
    """The cell ``name`` at a tiny size, batch ``batch`` (its own by
    default, at most 4), and the other traffic keys given."""
    cell = harness.load_cell(name)
    route = cell.config["route"]
    b = min(cell.traffic["batch"], 4) if batch is None else batch
    cell.traffic = {**cell.traffic, **TINY[route], "batch": b, "check_requests": 2,
                    "warmup_requests": 2, **traffic}
    if route == "sgm":
        cell.config = {**cell.config,
                       "params": {**cell.params, "num_disparities": SGM_DISPARITIES}}
    return cell
