"""Prediction cascades."""
