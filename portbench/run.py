"""Run one benchmark cell of pixsfm_tpu_torch once, on the card it is
started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and the compared numbers beside their limits as the last lines of standard
error. Exits with another code than 0, printing no result, without a card.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, "portbench", "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], T_START, ROOT))
