"""Profile one served prefill and decode step of a ``chip_smoke.py`` path-14
config with the code of a given tree, on one CUDA card; prints one line
``AB {json}`` (prefill and decode wall s, the profiled device-busy ms and
launches of each phase, the card's name and power limit).

To compare two commits on the same card, unpack the parent under a
directory ``.gitignore`` lists and run parent, change, change, parent,
one process each (two trees cannot share one process: both are
``repro_torch``)::

    git archive HEAD~1 | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/profile_serve_tree.py "$t" granite_moe_3b_a800m
    done
"""
import json
import os
import subprocess
import sys

root = os.path.abspath(sys.argv[1])
arch = sys.argv[2] if len(sys.argv) > 2 else "granite_moe_3b_a800m"
sys.path[:0] = [root, os.path.join(root, "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402

assert cs.__file__.startswith(root) and repro_torch.__file__.startswith(
    root), (cs.__file__, repro_torch.__file__)
dev = torch.device("cuda")
cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
cs._build.build_all()
cfg = cs.path14_config(arch)
L, kernel = cs.PATH14[arch]
other = ({"flash_fwd_wgmma", "flash_fwd_mma"} - {kernel}).pop()
params, prompt, _, res, _, _ = cs.serve_request(dev, cfg)
cs.check_outputs(cfg, res)
phases = []
profiled = cs._profiled


def record(fn, tags, cpu=True):
    traced_s, rows = profiled(fn, tags, cpu)
    phases.append({"device_busy_ms": sum(r[0] for r in rows) * 1e-3,
                   "launches": sum(r[1] for r in rows),
                   "traced_s": traced_s})
    return traced_s, rows


cs._profiled = record
cs.profile_serve(params, cfg, prompt, res, {f"{kernel}<": L, f"{other}<": 0},
                 counted=lambda: {f"{k}<": cs.fa_ops.kernel_launches[k]
                                  for k in (kernel, other)})
print("AB " + json.dumps({"tree": sys.argv[1], "arch": arch, "card": cs.CARD,
                          "prefill_s": res.prefill_s,
                          "decode_ms": res.decode_ms_per_step,
                          "prefill": phases[0], "decode_step": phases[1]}))
