"""Environment/dataset sanity checks (port of automoe_tpu/tools/checks.py).

Counterparts of the reference's utility scripts (SURVEY.md §2.1 S7):
  * check_nuscenes — dataset availability scan (scripts/check_nuscenes.py)
  * check_carla    — simulator connectivity ping (scripts/test_carla.py)
  * check_cuda     — the GPU probe (the JAX package's check_tpu): whether
    CUDA is available, the devices' names and capabilities, and a finite
    128x128 matmul on the first card. Without a GPU it reports
    cuda_available false and 0 devices, and runs no matmul.

    python -m automoe_tpu_torch.tools.checks nuscenes|carla|cuda [options]
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def check_nuscenes(dataroot: str, version: str) -> dict:
    root = Path(dataroot)
    report = {
        "dataroot": str(root),
        "version": version,
        "exists": root.exists(),
        "tables_present": False,
        "n_sweeps_files": 0,
        "devkit_available": False,
    }
    tables = root / version
    if tables.exists():
        expected = {"scene.json", "sample.json", "sample_data.json"}
        present = {p.name for p in tables.glob("*.json")}
        report["tables_present"] = expected.issubset(present)
    sweeps = root / "sweeps"
    if sweeps.exists():
        report["n_sweeps_files"] = sum(1 for _ in sweeps.rglob("*") if _.is_file())
    try:
        import nuscenes  # noqa: F401

        report["devkit_available"] = True
    except ImportError:
        pass
    return report


def check_carla(host: str, port: int, timeout: float = 5.0) -> dict:
    report = {"host": host, "port": port, "client_installed": False,
              "server_reachable": False, "version": None}
    try:
        import carla
    except ImportError:
        return report
    report["client_installed"] = True
    try:
        client = carla.Client(host, port)
        client.set_timeout(timeout)
        report["version"] = client.get_server_version()
        report["server_reachable"] = True
    except RuntimeError:
        pass
    return report


def check_cuda() -> dict:
    import torch

    report = {
        "torch": torch.__version__,
        "cuda_build": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "n_devices": 0,
        "devices": [],
        "matmul_ok": None,
    }
    if not report["cuda_available"]:
        return report
    report["n_devices"] = torch.cuda.device_count()
    report["devices"] = [
        {"name": torch.cuda.get_device_name(i),
         "capability": list(torch.cuda.get_device_capability(i))}
        for i in range(report["n_devices"])
    ]
    x = torch.ones(128, 128, device="cuda")
    report["matmul_ok"] = bool(torch.isfinite(x @ x).all().item())
    return report


def main(argv=None):
    p = argparse.ArgumentParser("automoe-check-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pn = sub.add_parser("nuscenes")
    pn.add_argument("--dataroot",
                    default=os.environ.get("NUSC_DATAROOT", "datasets/nuscenes/raw"))
    pn.add_argument("--version",
                    default=os.environ.get("NUSC_VERSION", "v1.0-mini"))
    pc = sub.add_parser("carla")
    pc.add_argument("--host", default="127.0.0.1")
    pc.add_argument("--port", type=int, default=2000)
    sub.add_parser("cuda")
    args = p.parse_args(argv)

    if args.cmd == "nuscenes":
        out = check_nuscenes(args.dataroot, args.version)
    elif args.cmd == "carla":
        out = check_carla(args.host, args.port)
    else:
        out = check_cuda()
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
