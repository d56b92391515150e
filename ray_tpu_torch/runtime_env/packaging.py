"""Content-addressed package creation, upload, and node-local caching.

Analog of the reference's ``python/ray/_private/runtime_env/packaging.py``
(``get_uri_for_directory``, ``upload_package_if_needed``,
``download_and_unpack_package``): a directory becomes a deterministic zip
whose URI is a content hash; workers extract it once per node into a cache
keyed by the URI, guarded against concurrent extraction by an atomic rename.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import tempfile
import zipfile
from typing import Callable, Iterable, Optional, Tuple

# Same spirit as the reference's 500 MiB  default cap
# (RAY_RUNTIME_ENV_WORKING_DIR_CACHE_SIZE_GB); keep uploads sane.
MAX_PACKAGE_BYTES = 512 * 1024 * 1024

_DEFAULT_EXCLUDES = {"__pycache__", ".git", ".venv", "node_modules"}


def _iter_files(root: str, excludes: Iterable[str]) -> Iterable[str]:
    ex = set(_DEFAULT_EXCLUDES) | set(excludes or ())
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ex)
        for f in sorted(filenames):
            if f in ex or f.endswith(".pyc"):
                continue
            yield os.path.join(dirpath, f)


def package_directory(path: str,
                      excludes: Optional[Iterable[str]] = None
                      ) -> Tuple[str, bytes]:
    """(uri, zip_bytes) for a local directory; deterministic per content."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env package path is not a directory: "
                         f"{path}")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for fpath in _iter_files(path, excludes or ()):
            rel = os.path.relpath(fpath, path)
            # Fixed timestamp => identical bytes for identical content.
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(fpath).st_mode & 0xFFFF) << 16
            with open(fpath, "rb") as f:
                zf.writestr(info, f.read())
    data = buf.getvalue()
    if len(data) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path} is {len(data)} bytes "
            f"(max {MAX_PACKAGE_BYTES}); use 'excludes' to trim it")
    digest = hashlib.sha1(data).hexdigest()[:20]
    return f"pkg://{digest}.zip", data


def package_file(path: str) -> Tuple[str, bytes]:
    """(uri, bytes) for a single local .zip / .whl file."""
    path = os.path.abspath(os.path.expanduser(path))
    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha1(data).hexdigest()[:20]
    ext = ".whl" if path.endswith(".whl") else ".zip"
    return f"pkg://{digest}{ext}", data


def default_cache_dir() -> str:
    return os.environ.get(
        "RAY_TPU_TORCH_PKG_CACHE",
        os.path.join(tempfile.gettempdir(), "ray_tpu_pkg_cache"))


def ensure_local_package(uri: str, fetch: Callable[[str], Optional[bytes]],
                         cache_dir: Optional[str] = None) -> str:
    """Materialize ``uri`` locally; returns the extracted directory (or the
    file path for .whl). ``fetch(uri)`` pulls the bytes (GCS KV).

    Concurrency-safe via extract-to-temp + atomic rename: losers of the
    race just delete their temp copy.
    """
    cache_dir = cache_dir or default_cache_dir()
    name = uri.split("//", 1)[1]
    target = os.path.join(cache_dir, name.rsplit(".", 1)[0])
    if os.path.exists(target):
        return target
    data = fetch(uri)
    if data is None:
        raise FileNotFoundError(f"runtime_env package {uri} not found in "
                                f"cluster KV store")
    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cache_dir, prefix=".extract-")
    try:
        if name.endswith(".whl"):
            # Keep the wheel as-is (its path goes straight onto sys.path);
            # the target dir holds the single file.
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(bytes(data))
        else:
            with zipfile.ZipFile(io.BytesIO(bytes(data))) as zf:
                zf.extractall(tmp)
        try:
            os.rename(tmp, target)
        except OSError:
            if not os.path.exists(target):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target
