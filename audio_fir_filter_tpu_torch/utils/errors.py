"""Typed exceptions driving CLI behavior.

Mirrors the capability of the reference's c_lib ``DiskerrorExceptions``
(interface reconstructed from call sites, see SURVEY.md §2.2 and
the reference's main.cp:65-66,90,94-107,150-164):

- ``StopNoError``  — happy-path early exit (e.g. ``--help``), exit code 0.
- ``FileNotFound`` — an input path does not exist / is not a regular file.
- ``FileExists``   — output exists and ``--overwrite`` was not given.
- ``UsageError``   — invalid argument combination / scenario.

All error types other than ``StopNoError`` produce exit code 1 with the
message on stderr (reference: main.cp:157-164).
"""

from __future__ import annotations


class DiskerrorError(Exception):
    """Base class for all framework errors (exit code 1)."""


class StopNoError(Exception):
    """Raised to stop with a message (or none) and exit code 0.

    Reference: thrown for ``--help`` at main.cp:65-66, caught at
    main.cp:153-156 which prints the payload and returns EXIT_SUCCESS.
    """


class FileNotFound(DiskerrorError):
    def __init__(self, path: str):
        super().__init__(f"File not found: {path}")
        self.path = path


class FileExists(DiskerrorError):
    def __init__(self, path: str):
        super().__init__(
            f"File exists: {path} (use -O/--overwrite to replace existing files)"
        )
        self.path = path


class UsageError(DiskerrorError):
    pass


class AudioFormatError(DiskerrorError):
    """Malformed or unsupported audio container/encoding."""
