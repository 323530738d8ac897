"""Rollout collection and evaluation."""
