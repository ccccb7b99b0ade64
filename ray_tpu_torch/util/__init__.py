"""Utilities over the runtime: placement groups, scheduling strategies and
the actor-backed ``Queue``."""
