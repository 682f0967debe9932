"""What a pytest run leaves on the disk: the bytes under each test's temp dir
(tmp_path, or a fixture's tmp_path_factory.mktemp dir), mapped to its test
file and summed per file and for the port's files (tests/test_torch_*.py)
against the rest.

    python3 port_tools/test_footprint.py scan <base temp> [--json OUT]
    python3 port_tools/test_footprint.py run [--json OUT] -- <shell command>

`scan` reads a finished run's base temp (pytest-of-$USER/pytest-N, with its
popen-gwK dirs under xdist). `run` runs the command with bash from the repo
root, sums the bytes of the files under the base temp the run makes (the
newest pytest-N under pytest's root) every 10 s for the peak, reads the
free space of that disk before and after, then scans the base temp and
prints the rc and the pass count the command printed (DOTS_PASSED=). A dir's name is its test's name
cut to 30 characters (pytest's rule) or the fixture's mktemp name; where a
name fits tests in several files, the file that has other dirs on the same
xdist worker wins (one worker runs a whole file under --dist loadfile).
"""

import argparse
import getpass
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.join(REPO, "tests")
SAMPLE_S = 10.0
GB = 1e9


def _tree_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.lstat(os.path.join(root, f)).st_size
            except OSError:  # removed while we walked
                pass
    return total


def _dir_names() -> dict:
    """{temp dir base name: {test file}} from the tests' function names and
    their mktemp calls."""
    names = {}
    for f in sorted(os.listdir(TESTS)):
        if not (f.startswith("test_") and f.endswith(".py")):
            continue
        src = open(os.path.join(TESTS, f)).read()
        for n in re.findall(r"^\s*def (test_\w+)\(", src, re.M):
            names.setdefault(n[:30], set()).add(f)
        for n in re.findall(r"mktemp\(\s*[\"'](\w+)[\"']", src):
            names.setdefault(n, set()).add(f)
    return names


def _candidates(base: str, names: dict) -> set:
    """Files whose test or mktemp name gives the dir name `base` (a test's
    parameters follow its name: test_x[a] -> test_x_a_)."""
    if base in names:
        return set(names[base])
    out = set()
    for n, files in names.items():
        if n.startswith("test_") and (base.startswith(n + "_") or (len(base) == 30 and n.startswith(base))):
            out |= files
    return out


def scan(basetemp: str) -> dict:
    """Bytes left per test dir, per test file and per side (port / other)."""
    names = _dir_names()
    workers = sorted(d for d in os.listdir(basetemp) if os.path.isdir(os.path.join(basetemp, d)))
    if not any(w.startswith("popen-gw") for w in workers):
        workers = ["."]
    dirs = []
    for w in workers:
        wdir = os.path.join(basetemp, w)
        for d in sorted(os.listdir(wdir)):
            path = os.path.join(wdir, d)
            if os.path.islink(path) or not os.path.isdir(path):
                continue
            base = re.sub(r"\d+$", "", d)
            dirs.append({"worker": w, "dir": d, "bytes": _tree_bytes(path), "files": _candidates(base, names)})
    on_worker = {}
    for e in dirs:
        if len(e["files"]) == 1:
            on_worker.setdefault(e["worker"], set()).update(e["files"])
    for e in dirs:
        if len(e["files"]) > 1 and len(e["files"] & on_worker.get(e["worker"], set())) == 1:
            e["files"] = e["files"] & on_worker[e["worker"]]
        e["file"] = "|".join(sorted(e["files"])) or "?"
        del e["files"]
    per_file = {}
    for e in dirs:
        per_file[e["file"]] = per_file.get(e["file"], 0) + e["bytes"]
    port = sum(b for f, b in per_file.items() if f.startswith("test_torch_") and "|" not in f)
    return {"basetemp": basetemp, "bytes": sum(per_file.values()), "port_bytes": port,
            "other_bytes": sum(per_file.values()) - port,
            "per_file": dict(sorted(per_file.items(), key=lambda kv: -kv[1])),
            "dirs": sorted(dirs, key=lambda e: -e["bytes"])}


def _pytest_root() -> str:
    return os.path.join(tempfile.gettempdir(), f"pytest-of-{getpass.getuser()}")


def _numbered(root: str) -> dict:
    if not os.path.isdir(root):
        return {}
    return {int(m.group(1)): os.path.join(root, d) for d in os.listdir(root) if (m := re.fullmatch(r"pytest-(\d+)", d))}


def run(command: str) -> dict:
    root = _pytest_root()
    os.makedirs(root, exist_ok=True)
    before = set(_numbered(root))
    free0 = shutil.disk_usage(root).free
    samples, done = [], threading.Event()
    t0 = time.monotonic()

    def sample():
        while not done.wait(SAMPLE_S):
            new = [p for n, p in _numbered(root).items() if n not in before]
            if new:
                samples.append((round(time.monotonic() - t0, 1), _tree_bytes(new[0]),
                                shutil.disk_usage(root).free))

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    proc = subprocess.run(["bash", "-c", command], cwd=REPO, capture_output=True, text=True)
    done.set()
    th.join()
    seconds = time.monotonic() - t0
    new = sorted(n for n in _numbered(root) if n not in before)
    out = {"command": command, "rc": proc.returncode, "seconds": round(seconds, 1),
           "free_before": free0, "free_after": shutil.disk_usage(root).free,
           "passed": int(m.group(1)) if (m := re.search(r"DOTS_PASSED=(\d+)", proc.stdout)) else None,
           "summary": [ln for ln in proc.stdout.splitlines() if re.search(r"\d+ (passed|failed|error)", ln)][-1:],
           "peak_bytes": max((s[1] for s in samples), default=None),
           "min_free": min((s[2] for s in samples), default=None), "samples": samples}
    if new:
        out.update(scan(_numbered(root)[new[-1]]))
    return out


def _report(r: dict) -> None:
    for k in ("command", "rc", "passed", "summary", "seconds", "free_before", "free_after", "peak_bytes", "min_free"):
        if k in r:
            v = r[k]
            print(f"{k}: {v / GB:.3f} GB" if isinstance(v, int) and k not in ("rc", "passed") else f"{k}: {v}")
    print(f"base temp {r['basetemp']}: {r['bytes'] / GB:.3f} GB left; port files {r['port_bytes'] / GB:.3f} GB, "
          f"other files {r['other_bytes'] / GB:.3f} GB")
    for f, b in r["per_file"].items():
        if b >= 1e6:
            print(f"  {b / GB:8.3f} GB  {f}")
    print("largest dirs:")
    for e in r["dirs"][:25]:
        print(f"  {e['bytes'] / GB:8.3f} GB  {e['worker']}/{e['dir']}  ({e['file']})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    s = sub.add_parser("scan")
    s.add_argument("basetemp")
    s.add_argument("--json")
    r = sub.add_parser("run")
    r.add_argument("--json")
    r.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.what == "scan":
        result = scan(args.basetemp)
    else:
        cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
        result = run(" ".join(cmd))
    _report(result)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
