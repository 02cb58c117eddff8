"""Synthetic prompts and calibration activations."""
