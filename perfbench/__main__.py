"""`python -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`."""

from perfbench.harness import process_start

T0 = process_start()

if __name__ == "__main__":
    import sys

    from perfbench.run import main

    sys.exit(main(sys.argv[1:], T0))
