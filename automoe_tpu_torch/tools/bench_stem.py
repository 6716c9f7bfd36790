"""K3 alone on the GPU: one or more builds of csrc/stem.cu, timed side by side.

    python -m automoe_tpu_torch.tools.bench_stem [--dtype bf16|f32]
        [--against OTHER/stem.cu ...] [--batch B ...]

Compiles the package's csrc/stem.cu and every `--against` source (each
must export the entry point of the chosen dtype: automoe_stem_s2d_pool_int8
for bf16, automoe_stem_s2d_pool_int8_f32 for f32) with the package's nvcc
flags plus `-Xptxas -v`, all at once, and prints for each build that
dtype's K3 kernel's registers, spill bytes and static shared memory,
ptxas's remarks on wgmma, and the count of HGMMA (tensor-core)
instructions in its SASS (`cuobjdump -sass`). Then, for each batch
(256x256 input, O = 256, seeded inputs; f32 inputs with TF32 off for the
plain version's conv; batches 8 and 128 in bf16, 8 and 32 in f32), it
holds every build against the plain version (ops/stem.py) and times its
entry point launched back to back on the same pre-built inputs: five
blocks of 50 launches, the builds interleaved block by block (the order
reversed every other round), the median block per build. Prints JSON
lines, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

SEED, BLOCKS, ITERS = 0, 5, 50
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame, "
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_usage(log: str, kernel: str = "s2d_stem_pool_int8_kernel") -> Dict[str, int]:
    """Registers, stack and spill bytes and static shared memory of `kernel`
    from nvcc's `-Xptxas -v` output."""
    chunks = _ENTRY.split(log)
    for name, body in zip(chunks[1::2], chunks[2::2]):
        if kernel not in name:
            continue
        usage = {"regs": None, "stack_bytes": 0, "spill_store_bytes": 0,
                 "spill_load_bytes": 0, "static_smem_bytes": 0}
        for m in _PROPS.finditer(body):  # the kernel's own, not a callee's
            if m[1] == name:
                usage.update(stack_bytes=int(m[2]), spill_store_bytes=int(m[3]),
                             spill_load_bytes=int(m[4]))
        m = _REGS.search(body)
        if m:
            usage["regs"] = int(m[1])
            usage["static_smem_bytes"] = int(m[2] or 0)
        return usage
    raise ValueError(f"no ptxas report for {kernel}")


def build_verbose(src: Path, out_dir: Path, extra_flags: Sequence[str] = ()):
    """Compile `src` with the package's nvcc flags, `extra_flags` and
    `-Xptxas -v` into out_dir; (loaded library, nvcc's report)."""
    from automoe_tpu_torch.ops._ext import NVCC_FLAGS, nvcc_path

    flags = NVCC_FLAGS + list(extra_flags) + ["-Xptxas", "-v"]
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = out_dir / f"{src.stem}_{digest}.so"
    res = subprocess.run([nvcc_path(), *flags, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    return ctypes.CDLL(str(out)), res.stdout + res.stderr


def count_sass(sass: str, kernel: str, opcode: str = "HGMMA") -> int:
    """Instructions with the given opcode in `kernel`'s function of a
    `cuobjdump -sass` listing."""
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel in body.split("\n", 1)[0]:
            return len(re.findall(rf"\b{opcode}\b", body))
    raise ValueError(f"no SASS for {kernel}")


def sass_count(lib_path: str, kernel: str, opcode: str = "HGMMA") -> int:
    """count_sass over the SASS of a built library (the toolkit's cuobjdump)."""
    from automoe_tpu_torch.ops._ext import nvcc_path

    res = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", lib_path],
                         capture_output=True, text=True, check=True, timeout=120)
    return count_sass(res.stdout, kernel, opcode)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def interleaved_ms(launch: Callable[[int], None], n: int) -> List[List[float]]:
    """Per build k < n, BLOCKS blocks of ITERS back-to-back `launch(k)`, the
    builds in turn block by block (the order reversed every other round);
    the mean ms of each block (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    blocks: List[List[float]] = [[] for _ in range(n)]
    for r in range(BLOCKS):
        for k in (range(n) if r % 2 == 0 else reversed(range(n))):
            torch.cuda.synchronize()
            start.record()
            for _ in range(ITERS):
                launch(k)
            end.record()
            end.synchronize()
            blocks[k].append(start.elapsed_time(end) / ITERS)
    return blocks


#: per dtype: (C entry point, kernel name in ptxas and SASS, LAUNCHES key)
_DTYPES = {
    "bf16": ("automoe_stem_s2d_pool_int8", "s2d_stem_pool_int8_kernel", "s2d_stem_pool_int8"),
    "f32": ("automoe_stem_s2d_pool_int8_f32", "s2d_stem_pool_int8_f32_kernel",
            "s2d_stem_pool_int8_f32"),
}


def _build(src: Path, out_dir: Path, dtype: str):
    entry, kernel, _ = _DTYPES[dtype]
    lib, log = build_verbose(src, out_dir)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    report = {"ptxas": ptxas_usage(log, kernel),
              "ptxas_wgmma_remarks": [ln.strip() for ln in log.splitlines() if "wgmma" in ln],
              "hgmma_count": sass_count(lib._name, kernel)}
    return fn, report


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16",
                   help="K3's input dtype: the bf16 kernel or the f32 one")
    p.add_argument("--against", action="append", default=[], type=Path,
                   help="another stem.cu to time beside the package's")
    p.add_argument("--batch", type=int, nargs="+",
                   help="batches (default 8 128 in bf16, 8 32 in f32)")
    args = p.parse_args(argv)
    batches = args.batch or ([8, 128] if args.dtype == "bf16" else [8, 32])

    import torch

    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.ops._ext import BUILD_DIR

    # the f32 plain version's conv in f32, not TF32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": card_name(), "dtype": args.dtype}), flush=True)
    sources = [Path(stem.__file__).resolve().parents[1] / "csrc" / "stem.cu", *args.against]
    out_dir = BUILD_DIR.parent / "bench_stem"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda s: _build(s, out_dir, args.dtype), sources))
    for src, (_, report) in zip(sources, built):
        print(json.dumps({"source": str(src), **report}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for B in batches:
        xs = torch.randn(B, 132, 132, 12, device="cuda", generator=gen)
        w = torch.randn(192, 256, device="cuda", generator=gen) * 0.05
        if args.dtype == "bf16":
            xs, w = xs.bfloat16(), w.bfloat16()
        bias = torch.randn(256, device="cuda", generator=gen) * 0.1
        inv = 127.0 / (torch.rand(256, device="cuda", generator=gen) * 4 + 1)
        ref = stem.s2d_stem_pool_int8_plain(xs, w, bias, inv)
        outs = [torch.empty_like(ref) for _ in built]

        def launch(k: int) -> None:
            stem.raise_on(built[k][0](
                xs.data_ptr(), w.data_ptr(), bias.data_ptr(), inv.data_ptr(),
                outs[k].data_ptr(), B, 132, 132, 256, stream), _DTYPES[args.dtype][2])

        errs = []
        for k in range(len(built)):
            launch(k)
            torch.cuda.synchronize()
            d = (outs[k].int() - ref.int()).abs()
            errs.append((int(d.max()), float((d > 0).float().mean())))
            for _ in range(3):
                launch(k)
        blocks = interleaved_ms(launch, len(built))
        for k, src in enumerate(sources):
            print(json.dumps({"batch": B, "source": str(src), "ms": float(np.median(blocks[k])),
                              "ms_blocks": blocks[k], "max_abs_err": errs[k][0],
                              "diff_frac": errs[k][1]}), flush=True)


if __name__ == "__main__":
    main()
