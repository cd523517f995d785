"""Fixture: the plain versions (no `tripled`)."""


def doubled(x):
    return x * 2.0
