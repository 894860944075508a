"""Per-call tables of K5 (`strided_dw`) and K6 (`segment_sum`) from
`chip_smoke.py` logs, several runs side by side (e.g. a parent and a
change run in turns in one chip call):

    python3 tools/k5k6_calls.py parent1.txt change1.txt change2.txt parent2.txt

For each call the script's log names (the bf16 MinkUNet / KD step calls
of `phase_train_kernels`, TIAF's f32 calls of `phase_tiaf_kernels`,
RPVNet's pixel tables), it prints `cuda_ms` and device ms per log, the
yardstick (`index_add_` for K6, one `torch.mm` for K5) and the bound, and
per log the sums over TIAF's step (each call by its count) and each
path's device ms per step of both kernels (`profiler train ...`).
Nothing runs on a card: it reads the logs.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

NUM = r"([0-9.]+|not measured)"
# "... x{count}/step ... kernel X ms device Y ..." lines of both phases
CALL = re.compile(
    r"^(?P<label>(?:tiaf )?(?:K6 over the |segment_sum |strided_dw ).*?)\s+x(?P<count>\d+)/step"
    r".*?kernel (?P<ms>[0-9.]+) ms"
)
# the kernel's own device time: not the yardstick's ("yardstick device",
# "torch.mm device", "index_add_ ... (device")
DEVICE = re.compile(r"(?<!yardstick )(?<!torch\.mm )(?<!\()device " + NUM)
LIB = re.compile(r"(?:index_add_|one torch\.mm) ([0-9.]+) ms")
BOUND = re.compile(r"(?<!inclusive )(?<!'s )bound ([0-9.]+) ms")  # the recounted one
STEP = re.compile(r"^(\w+ )?profiler train (segment_sum|strided_dw): ([0-9.]+) ms per step")


def parse(path: Path) -> tuple[dict, dict]:
    calls, steps = {}, {}
    for line in path.read_text().splitlines():
        m = STEP.match(line)
        if m:
            steps[((m.group(1) or "minkunet ").strip(), m.group(2))] = float(m.group(3))
            continue
        m = CALL.match(line)
        if not m or "max|err|" not in line:
            continue
        if "float32" in line and not line.startswith("tiaf"):
            continue  # the bf16 step's once-in-f32 checks are not timed
        label = re.sub(r" (max\|err\||route).*", "", m.group("label"))
        dev = DEVICE.search(line)
        lib, bound = LIB.search(line), BOUND.search(line)
        key = (label, int(m.group("count")))
        calls.setdefault(key, []).append((
            float(m.group("ms")),
            None if dev is None or dev.group(1) == "not measured" else float(dev.group(1)),
            float(lib.group(1)) if lib else None,
            float(bound.group(1)) if bound else None,
        ))
    return calls, steps


def fmt(x) -> str:
    return "—" if x is None else f"{x:.4f}"


def main(paths: list[str]) -> None:
    runs = [parse(Path(p)) for p in paths]
    names = [Path(p).stem for p in paths]
    keys = sorted({k for calls, _ in runs for k in calls}, key=lambda k: k[0])
    print("| call | count | " + " | ".join(f"{n} ms / device" for n in names) + " | yardstick | bound |")
    print("| --- | --- |" + " --- |" * (len(names) + 2))
    for key in keys:
        cells, lib, bound = [], None, None
        for calls, _ in runs:
            got = calls.get(key)
            if not got:
                cells.append("—")
                continue
            ms, dev, lib, bound = got[0]
            cells.append(f"{fmt(ms)} / {fmt(dev)}")
        print(f"| {key[0]} | {key[1]} | " + " | ".join(cells) + f" | {fmt(lib)} | {fmt(bound)} |")
    print()
    for name, (calls, steps) in zip(names, runs):
        for kern, tag in (("K6", ("tiaf K6",)), ("K5", ("tiaf strided_dw",))):
            tiaf = [(v[0], k[1]) for k, v in calls.items() if k[0].startswith(tag)]
            total = sum(ms * n for (ms, *_), n in tiaf)
            lib = sum((v[0][2] or 0.0) * k[1] for k, v in calls.items() if k[0].startswith(tag))
            print(f"{name}: {kern} per TIAF step {total:.4f} ms over {sum(n for _, n in tiaf)} calls"
                  f" (yardstick {lib:.4f})")
        for (path, kern), ms in sorted(steps.items()):
            if ms:
                print(f"{name}: {path} {kern} device {ms:.4f} ms per step")


if __name__ == "__main__":
    main(sys.argv[1:])
