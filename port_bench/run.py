"""Run one benchmark cell once:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (see ``port_bench/harness.py``).
"""

import sys

from port_bench.harness import main

if __name__ == "__main__":
    sys.exit(main())
