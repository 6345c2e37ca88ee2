"""Data made from a seed: synthetic MNIST-geometry rows and the 2-D toy densities."""
