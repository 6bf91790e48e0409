"""Pipelines built on the port: the paper's Fig-9 speech-enhancement
SigProgram (the counterpart of ``examples/speech_enhancement.py``)."""

from . import speech_enhancement  # noqa: F401

__all__ = ["speech_enhancement"]
