"""The config-driven runner."""

from .runner import Runner  # noqa: F401
