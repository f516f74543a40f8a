"""MNIST pixel statistics (on [0, 1] pixels), copied from the reference
package's ``data/mnist.py``."""

MEAN, STD = 0.1307, 0.3081
