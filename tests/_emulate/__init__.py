"""The flash kernels' CUDA C++ run on the host, to check their logic
without a card or ``nvcc``.

``build(name)`` copies ``csrc/<name>.cu`` and the ``csrc`` headers,
replaces each function that holds inline asm (``cp.async``, the fences,
``wgmma``, ``ex2.approx``) with a host emulation (``wgmma.h``), turns each
``kernel<<<grid, block, smem, stream>>>(args);`` into a call of
``emu_launch``, and compiles the result with ``g++`` against the
``cuda_runtime.h`` and ``cuda_bf16.h`` of this directory, which run one
``std::thread`` per CUDA thread and the blocks one after another.
``load(name)`` binds the library as ``ops.attention`` binds the card's, so
the same entry point takes CPU tensors' data pointers.

What it checks: index arithmetic, masks, fragment layouts, the order of
copies, barriers and products, and the numerics of bf16 and fp32 inputs.
What it cannot: what the card's compiler decides (registers, spills,
speed), races that need real asynchrony (a copy lands at once here), and
the meaning of the wgmma descriptors, which it takes as the card was shown
to read them (K-major and MN-major tiles in the 128-byte swizzle, each
product held to torch on an H100). ``set_multiprocessors(lib, n)`` sets
the multiprocessor count the launchers see (132 until it is called).

This is a test tool: only ``tests/test_torch_emulate.py`` uses it, and it
reads the port's private build details (``_CSRC``, ``_BUILD_DIR``,
``_ARGTYPES``) to build and bind what the port builds and binds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from ray_tpu_torch.ops import attention

_HERE = Path(__file__).resolve().parent
_HOST_FILES = ("cuda_runtime.h", "cuda_bf16.h", "runtime.cpp", "wgmma.h")

# Each function of the headers that holds asm, and its host version.
_HOST_VERSIONS = {
    "cp_async16": "inline void cp_async16(uint32_t dst, const void* src, "
                  "bool full) { if (full) std::memcpy(emu_smem + dst, src, "
                  "16); else std::memset(emu_smem + dst, 0, 16); }",
    "cp_async4": "inline void cp_async4(uint32_t dst, const void* src, "
                 "bool full) { if (full) std::memcpy(emu_smem + dst, src, "
                 "4); else std::memset(emu_smem + dst, 0, 4); }",
    "cp_async_commit": "inline void cp_async_commit() {}",
    "cp_async_wait_all": "inline void cp_async_wait_all() {}",
    "fence_async_proxy": "inline void fence_async_proxy() {}",
    "wgmma_fence": "inline void wgmma_fence() {}",
    "wgmma_commit": "inline void wgmma_commit() {}",
    "wgmma_wait_all": "inline void wgmma_wait_all() {}",
    "fence_regs": "template <int N> inline void fence_regs(float (&)[N]) {}",
    "exp2_approx": "inline float exp2_approx(float x) { return exp2f(x); }",
}
for _n in (32, 64, 128):
    _HOST_VERSIONS[f"wgmma_ss<{_n}>"] = (
        f"template <> inline void wgmma_ss<{_n}>(float (&d)[{_n // 2}], "
        f"uint64_t a, uint64_t b, int acc) "
        f"{{ emu_wgmma_ss<{_n}>(d, a, b, acc); }}")
    _HOST_VERSIONS[f"wgmma_rs<{_n}>"] = (
        f"template <> inline void wgmma_rs<{_n}>(float (&d)[{_n // 2}], "
        f"const uint32_t (&a)[4], uint64_t b) "
        f"{{ emu_wgmma_rs<{_n}>(d, a, b); }}")

_SHARED = re.compile(r"extern __shared__ __align__\(\d+\) ([\w ]+?) (\w+)\[\];")
_LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _after_closing(text: str, i: int, opening: str, closing: str) -> int:
    """The index after the bracket that closes ``text[i]``, skipping
    string literals."""
    depth = 0
    while True:
        ch = text[i]
        if ch == '"':
            i += 1
            while text[i] != '"':
                i += 2 if text[i] == "\\" else 1
        elif ch == opening:
            depth += 1
        elif ch == closing:
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1


def _host_header(text: str) -> str:
    for name, host in _HOST_VERSIONS.items():
        found = re.search(r"(template <[^>]*>\s*)?__device__ __forceinline__ "
                          r"[\w:]+ " + re.escape(name) + r"\(", text)
        if not found:
            continue
        params_end = _after_closing(text, found.end() - 1, "(", ")")
        body = text.index("{", params_end)
        if text[params_end:body].strip():  # a declaration, not a definition
            continue
        text = (text[:found.start()] + host
                + text[_after_closing(text, body, "{", "}"):])
    code = re.sub(r'"(\\.|[^"\\])*"', '""', re.sub(r"//.*", "", text))
    if re.search(r"\basm\b", code):
        raise ValueError("a function with asm has no host version")
    return _SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(::emu_smem);", text)


def _host_source(text: str) -> str:
    def launch(m):
        grid, block, smem = (p.strip() for p in m.group(2).split(",")[:3])
        return (f"emu_launch(dim3({grid}), dim3({block}), {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    return _host_header(_LAUNCH.sub(launch, text))


def generate(name: str, out_dir: Path) -> Path:
    """Write the host version of ``csrc/<name>.cu`` and of every header
    into ``out_dir``; returns the source's path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in attention._CSRC.glob("*.cuh"):
        text = _host_header(header.read_text())
        if header.name == "flash_tc.cuh":  # the emulation's helpers
            text = text.replace(
                "namespace tc {\n",
                "namespace tc {\n" + (_HERE / "wgmma.h").read_text(), 1)
        (out_dir / header.name).write_text(text)
    source = out_dir / f"{name}.cpp"
    source.write_text(_host_source(
        (attention._CSRC / f"{name}.cu").read_text()))
    return source


def build(name: str = "flash_bwd") -> Path:
    """Compile the host version of ``csrc/<name>.cu`` with ``g++`` into
    ``_build/emulate/`` unless one from the same sources is there;
    returns the library's path."""
    if name not in attention.KERNELS:
        raise ValueError(f"unknown kernel library {name!r}")
    digest = hashlib.sha256(attention.source_digest(name).encode())
    for f in _HOST_FILES + ("__init__.py",):
        digest.update((_HERE / f).read_bytes())
    out = attention._BUILD_DIR / "emulate"
    lib = out / f"{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the host emulation needs it")
    with tempfile.TemporaryDirectory() as tmp:
        source = generate(name, Path(tmp))
        out.mkdir(parents=True, exist_ok=True)
        fd, partial = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        proc = subprocess.run(
            [compiler, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas", "-I", str(_HERE), "-o", partial,
             str(source), str(_HERE / "runtime.cpp")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(partial)
            raise RuntimeError(f"g++ failed on the host version of {name}.cu"
                               f":\n{proc.stderr[-4000:]}")
        os.replace(partial, lib)
    return lib


def load(name: str = "flash_bwd"):
    """The host version of library ``name``, its entry point bound with
    the card's argument types."""
    lib = ctypes.CDLL(str(build(name)))
    fn_name, argtypes = attention._ARGTYPES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.emu_set_multiprocessors.argtypes = [ctypes.c_int]
    lib.emu_set_multiprocessors.restype = None
    return lib


def set_multiprocessors(lib, n: int) -> None:
    """Make the launchers of ``lib`` see ``n`` multiprocessors, which
    chooses between the routes a launcher picks by the card's size."""
    lib.emu_set_multiprocessors(n)
