"""A pure-Python wheel written with ``zipfile``.

For a local ``pip`` env installed with ``--no-index``: the wheel holds the
given files and its ``METADATA``, ``WHEEL`` and ``RECORD``, so writing it
needs neither ``setuptools`` nor ``wheel``.
"""

from __future__ import annotations

import base64
import hashlib
import os
import zipfile
from typing import Dict


def write_wheel(directory: str, name: str, files: Dict[str, bytes],
                version: str = "1.0") -> str:
    """Write ``<name>-<version>-py3-none-any.whl`` into ``directory`` with
    ``files`` (archive path to contents) and return its path."""
    dist = f"{name}-{version}.dist-info"
    files = {**files,
             f"{dist}/METADATA": (f"Metadata-Version: 2.1\nName: {name}\n"
                                  f"Version: {version}\n").encode(),
             f"{dist}/WHEEL": (b"Wheel-Version: 1.0\nGenerator: zipfile\n"
                               b"Root-Is-Purelib: true\nTag: py3-none-any\n")}
    record = [f"{path},sha256=" + base64.urlsafe_b64encode(
        hashlib.sha256(data).digest()).rstrip(b"=").decode()
        + f",{len(data)}" for path, data in files.items()]
    files[f"{dist}/RECORD"] = "\n".join(
        record + [f"{dist}/RECORD,,"]).encode() + b"\n"
    path = os.path.join(directory, f"{name}-{version}-py3-none-any.whl")
    with zipfile.ZipFile(path, "w") as zf:
        for member, data in files.items():
            zf.writestr(member, data)
    return path
