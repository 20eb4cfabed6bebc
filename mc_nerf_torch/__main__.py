"""``python -m mc_nerf_torch --train | --demo ...``: see :mod:`mc_nerf_torch.main`."""

from mc_nerf_torch.main import main

if __name__ == "__main__":
    main()
