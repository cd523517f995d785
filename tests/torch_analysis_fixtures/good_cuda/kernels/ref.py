"""Fixture: the plain versions."""


def doubled(x):
    return x * 2.0
