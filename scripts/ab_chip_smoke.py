"""Compare ``chip_smoke.py``'s numbers between a base commit and the working
tree, on one card, with one timing method.

Three steps:

    python3 scripts/ab_chip_smoke.py prepare BASE [--dest scratch_chip/ab]

(in a git checkout) unpacks BASE into ``DEST/base`` and the working tree's
files as git would commit them (untracked files included, through a
temporary index; the repository's own index is not touched) into
``DEST/change``.  The base's ``time_ms`` in its ``chip_smoke.py`` is replaced
by the working tree's, so that both sides time every launch the same way; the
replaced lines are written to ``DEST/base/AB_PATCH.txt``.

    python3 scripts/ab_chip_smoke.py run [--dest ...] [--out scratch_chip/ab/out]
        [--order base,change,change,base,change]

(on the card) runs ``python3 chip_smoke.py`` in each copy in that order, one
process after the other, each log in ``OUT/<side><n>.log`` and ``.err``.

    python3 scripts/ab_chip_smoke.py summarize [--out ...] [KEY_SUBSTRING ...]

reads the logs and prints, for every number of the JSON lines (named by its
phase, kernel, dtype, grid and its path of keys), each side's median and
range over its runs; with substrings, only the names that hold one.  The
whole table goes to ``OUT/summary.json``.
"""

from __future__ import annotations

import argparse
import ast
import io
import json
import os
import statistics
import subprocess
import sys
import tarfile
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _git(*args: str, env=None) -> bytes:
    return subprocess.run(["git", *args], cwd=ROOT, check=True, capture_output=True,
                          env=env).stdout


def _unpack(tree: str, dest: str) -> None:
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(_git("archive", tree))) as tar:
        tar.extractall(dest, filter="data")


def _function_lines(source: str, name: str):
    """(first, last) line, 1-based, of the top-level function ``name``."""
    for node in ast.parse(source).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node.lineno, node.end_lineno
    raise SystemExit(f"no function {name} in chip_smoke.py")


def prepare(base: str, dest: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, GIT_INDEX_FILE=os.path.join(tmp, "index"))
        _git("read-tree", "HEAD", env=env)
        _git("add", "-A", env=env)
        tree = _git("write-tree", env=env).decode().strip()
    for side, rev in (("base", base), ("change", tree)):
        if os.path.exists(os.path.join(dest, side)):
            raise SystemExit(f"{dest}/{side} exists; remove it first")
        _unpack(rev, os.path.join(dest, side))
    new = open(os.path.join(dest, "change", "chip_smoke.py")).read().splitlines(True)
    path = os.path.join(dest, "base", "chip_smoke.py")
    old = open(path).read().splitlines(True)
    n0, n1 = _function_lines("".join(new), "time_ms")
    o0, o1 = _function_lines("".join(old), "time_ms")
    with open(path, "w") as f:
        f.writelines(old[:o0 - 1] + new[n0 - 1:n1] + old[o1:])
    with open(os.path.join(dest, "base", "AB_PATCH.txt"), "w") as f:
        f.write(f"base {base}, change tree {tree}\ntime_ms of chip_smoke.py, replaced:\n")
        f.writelines(old[o0 - 1:o1])
        f.write("by:\n")
        f.writelines(new[n0 - 1:n1])
    print(f"base {base} -> {dest}/base, change tree {tree} -> {dest}/change")


def run(dest: str, out: str, order: str, timeout: int) -> int:
    os.makedirs(out, exist_ok=True)
    seen, worst = {}, 0
    for side in order.split(","):
        seen[side] = seen.get(side, 0) + 1
        name = f"{side}{seen[side]}"
        with open(os.path.join(out, name + ".log"), "w") as log, \
                open(os.path.join(out, name + ".err"), "w") as err:
            try:
                rc = subprocess.run([sys.executable, "chip_smoke.py"],
                                    cwd=os.path.join(dest, side), stdout=log, stderr=err,
                                    timeout=timeout).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        print(f"{name} rc={rc}", flush=True)
        worst = worst or rc
    return worst


def _label(obj: dict) -> str:
    parts = [str(obj.get(k)) for k in ("phase", "kernel", "dtype", "grid") if k in obj]
    for k in ("in_dim", "levels"):
        if k in obj:
            parts.append(f"{k}{obj[k]}")
    return ".".join(parts)


def _numbers(obj, prefix: str, into: dict) -> None:
    if isinstance(obj, bool):
        return
    if isinstance(obj, (int, float)):
        into[prefix] = float(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _numbers(v, f"{prefix}.{k}", into)


def _read_log(path: str) -> dict:
    nums = {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        if "kernels" in obj:
            for k in obj["kernels"]:
                _numbers({n: v for n, v in k.items() if n != "name"}, f"kernels.{k['name']}",
                         nums)
        elif "phase" in obj:
            _numbers({n: v for n, v in obj.items() if n != "phase"}, _label(obj), nums)
    return nums


def summarize(out: str, wanted) -> None:
    runs = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".log"):
            side = name[:-4].rstrip("0123456789")
            runs.setdefault(side, []).append(_read_log(os.path.join(out, name)))
    table = {}
    for side, logs in runs.items():
        for key in sorted(set().union(*logs)):
            vals = [log[key] for log in logs if key in log]
            table.setdefault(key, {})[side] = {
                "median": statistics.median(vals), "min": min(vals), "max": max(vals),
                "runs": vals}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(table, f, indent=1)
    sides = sorted(runs)
    print("key\t" + "\t".join(f"{s} median (min-max, n={len(runs[s])})" for s in sides))
    for key, by_side in table.items():
        if wanted and not any(w in key for w in wanted):
            continue
        cells = []
        for s in sides:
            v = by_side.get(s)
            cells.append("-" if v is None else
                         f"{v['median']!r} ({v['min']!r}-{v['max']!r})")
        print(key + "\t" + "\t".join(cells))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("base")
    p.add_argument("--dest", default="scratch_chip/ab")
    r = sub.add_parser("run")
    r.add_argument("--dest", default="scratch_chip/ab")
    r.add_argument("--out", default="scratch_chip/ab/out")
    r.add_argument("--order", default="base,change,change,base,change")
    r.add_argument("--timeout", type=int, default=600)
    s = sub.add_parser("summarize")
    s.add_argument("--out", default="scratch_chip/ab/out")
    s.add_argument("keys", nargs="*")
    args = ap.parse_args()
    if args.cmd == "prepare":
        prepare(args.base, os.path.abspath(args.dest))
        return 0
    if args.cmd == "run":
        return run(os.path.abspath(args.dest), os.path.abspath(args.out), args.order,
                   args.timeout)
    summarize(args.out, args.keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
