"""`python -m repro_torch.serve` -- the serving CLI (see loop.main)."""
from repro_torch.serve.loop import main

if __name__ == "__main__":
    main()
