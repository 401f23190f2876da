"""Status codes and error handling.

Mirrors the reference's failure model: status codes across the API, no
uncontrolled exceptions (reference ``hotpath/include/hotpath/hp.h:30-37``,
``include/dvren/core/status.hpp``, ``src/core/status.cpp:10-80``).

The Python-native surface raises :class:`DvrenError` (carrying a
:class:`Status`), while the :class:`Status`-returning helpers support the
reference-style "check and branch" flow used by the CLI and the Renderer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class StatusCode(enum.IntEnum):
    """1:1 with ``hp_status`` (reference hp.h:30-37)."""

    OK = 0
    INVALID_ARGUMENT = 1
    OUT_OF_MEMORY = 2
    NOT_IMPLEMENTED = 3
    UNSUPPORTED = 4
    INTERNAL_ERROR = 5


_CODE_NAMES = {
    StatusCode.OK: "ok",
    StatusCode.INVALID_ARGUMENT: "invalid_argument",
    StatusCode.OUT_OF_MEMORY: "out_of_memory",
    StatusCode.NOT_IMPLEMENTED: "not_implemented",
    StatusCode.UNSUPPORTED: "unsupported",
    StatusCode.INTERNAL_ERROR: "internal_error",
}


@dataclass(frozen=True)
class Status:
    """Result of an operation; mirrors ``dvren::Status``."""

    code: StatusCode = StatusCode.OK
    message: str = ""

    @staticmethod
    def ok() -> "Status":
        return Status(StatusCode.OK, "")

    @staticmethod
    def invalid_argument(message: str) -> "Status":
        return Status(StatusCode.INVALID_ARGUMENT, message)

    @staticmethod
    def unsupported(message: str) -> "Status":
        return Status(StatusCode.UNSUPPORTED, message)

    @staticmethod
    def internal_error(message: str) -> "Status":
        return Status(StatusCode.INTERNAL_ERROR, message)

    def is_ok(self) -> bool:
        return self.code == StatusCode.OK

    def __bool__(self) -> bool:
        return self.is_ok()

    def to_string(self) -> str:
        name = _CODE_NAMES.get(self.code, "unknown")
        if self.message:
            return f"{name}: {self.message}"
        return name

    def raise_if_error(self) -> None:
        if not self.is_ok():
            raise DvrenError(self)


class DvrenError(Exception):
    """Exception carrying a :class:`Status`."""

    def __init__(self, status: Status):
        super().__init__(status.to_string())
        self.status = status

    @staticmethod
    def invalid_argument(message: str) -> "DvrenError":
        return DvrenError(Status.invalid_argument(message))

    @staticmethod
    def unsupported(message: str) -> "DvrenError":
        return DvrenError(Status.unsupported(message))


def check(condition: bool, message: str) -> None:
    """Raise ``DvrenError(INVALID_ARGUMENT)`` unless ``condition`` holds."""
    if not condition:
        raise DvrenError.invalid_argument(message)
