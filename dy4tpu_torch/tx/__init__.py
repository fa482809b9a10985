"""Broadcast synthesis (numpy + scipy), for tests and the chip smoke."""
