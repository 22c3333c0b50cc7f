"""Experiment harnesses of the port."""
