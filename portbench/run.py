"""Entry point of the port's benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It exits with another code than 0, and
prints no result, without the cards the cell asks for, without the program
beside it, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()        # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the port's kernel build and any library cache stay inside the checkout or
# the run's own HOME / TMPDIR; nothing of JAX may load
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

from portbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T0))
