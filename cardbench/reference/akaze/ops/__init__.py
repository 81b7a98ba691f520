"""The plain versions of the AKAZE ops, frozen for the benchmark's
reference: the same arithmetic as the port's plain PyTorch paths, with no
kernel behind any of them."""
