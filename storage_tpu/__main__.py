"""``python -m storage_tpu`` — the CLI front-end (see storage_tpu/cli.py)."""
import sys

from .cli import main
from .utils.compile_cache import enable_compile_cache

enable_compile_cache()
sys.exit(main())
