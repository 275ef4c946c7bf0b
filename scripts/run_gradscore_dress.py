"""Driver: bench.bench_e2e_gradscore_dress alone, result to
bench_runs/gradscore_dress_<ts>.json."""
import importlib.util
import json
import os
import sys
import time

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo)
spec = importlib.util.spec_from_file_location(
    "benchmod", os.path.join(repo, "bench.py"))
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.device_info()
out = m.bench_e2e_gradscore_dress()
stamp = time.strftime("%Y%m%dT%H%M%S")
os.makedirs(os.path.join(repo, "bench_runs"), exist_ok=True)
path = os.path.join(repo, "bench_runs", f"gradscore_dress_{stamp}.json")
with open(path, "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps({"saved": path,
                  "host": out["host_pack"]["targets_per_s"],
                  "device": out["device_store"]["targets_per_s"],
                  "speedup": out["speedup_device_over_host"]}))
