from semicp_torch.data.synthetic import make_pair, make_scene  # noqa: F401
