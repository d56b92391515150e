"""Testing utilities: mocks + instrumentation assertions.

Analog of the reference's ``src/mock/ray/`` GMock mirror (every component
unit-testable against mocked peers) and ``python/ray/_private/test_utils``.
"""

from .mocks import MockConnection, gcs_harness, MockGcsHarness

__all__ = ["MockConnection", "MockGcsHarness", "gcs_harness"]
