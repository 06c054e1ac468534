"""Run one benchmark cell once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); everything else goes to standard error.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches sit at fixed paths inside the checkout (its own
# nvcc build lives in build/kernels)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "perfbench", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench", "triton")
os.environ.setdefault("USE_FLAX", "0")  # a library that could load JAX by itself
# the package, not its files, is importable: drop the script's own folder
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.join(ROOT, "perfbench")]
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
