"""``python -m graphgps_torch.main --cfg <yaml> [--device cuda|cpu] [key value ...]``"""
from .driver import main

if __name__ == "__main__":
    main()
