"""Example command lines of the port: multilayer-perceptron policies."""
