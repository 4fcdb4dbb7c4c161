"""Plain references of the port's pipelines: straightforward PyTorch
implementations of the upstream semantics, sharing no code with either
package, for tests and card checks to hold the port against."""
