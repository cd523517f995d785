"""Fixture: the binding of csrc/fake.cu, which leaves an entry unbound."""
from .launch import launches, load_lib, stream

_ARGTYPES: dict = {}      # fake_doubled left out


def _lib():
    return load_lib("fake", _ARGTYPES, "fake_error_string")


def doubled(x):
    out = x.new_empty(x.shape)
    _lib().fake_doubled(x.data_ptr(), out.data_ptr(), x.numel(),
                        stream(x.device))
    launches["doubled"] += 1
    return out


def halved(x):  # VIOLATION: cuda-ref
    out = x.new_empty(x.shape)
    _lib().fake_doubled(x.data_ptr(), out.data_ptr(), x.numel(),
                        stream(x.device))
    launches["halved"] += 1
    return out
