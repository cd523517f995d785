"""Fixture: telemetry accumulated on the device; host reads after the run."""
import torch

CLOCK_STEP = ("step",)


def device_update(acc, lag):
    # the sanctioned route: accumulate on the device, drain after the run
    return {"lag_max": torch.maximum(acc["lag_max"], lag.amax())}


def step(acc, x, c: int):
    lag = torch.abs(x)
    acc = device_update(acc, lag)
    probe = float(lag.amax())  # analysis: ignore[host-sync] -- one-off kernel debugging probe
    keep = torch.where(lag > 0, x, 0.0) if c % 2 else x
    return acc, keep * 2 + probe + int(x.shape[0]) + float(c)


def report(acc):
    # host side, never in a clock step: reading here is fine
    print("final lag_max =", acc["lag_max"].item())
    print("report done")
