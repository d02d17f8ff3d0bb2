"""``python -m sypha`` — the CLI entry point (reference src/main.cpp)."""

import sys

from sypha.cli import main

if __name__ == "__main__":
    sys.exit(main())
