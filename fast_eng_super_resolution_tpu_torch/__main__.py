"""``python -m fast_eng_super_resolution_tpu_torch --mode=train|pred ...`` — the
same flags as run_ALDS_3D.py (utils/config.parse_args)."""

from .runner import main
from .utils.config import parse_args

if __name__ == "__main__":
    main(parse_args())
