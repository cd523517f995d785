"""Fixture: host syncs landed inside the clock-step scope."""
import torch

CLOCK_STEP = ("step", "run")


# the clock step (CLOCK_STEP above)
def step(x):
    print("x =", x.item())  # VIOLATION: host-sync
    torch.cuda.synchronize()  # VIOLATION: host-sync
    return x * 2


def body(carry, t):
    lag = float(carry.amax())  # VIOLATION: host-sync
    if (carry > t).any():  # VIOLATION: host-sync
        carry = carry - t
    return carry + t + lag, t


def run(xs):
    return [body(x, x)[0] for x in xs]
