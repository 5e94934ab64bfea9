"""Sampling schedules."""
