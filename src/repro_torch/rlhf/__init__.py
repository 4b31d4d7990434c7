"""Rollout side of the RLHF stack: sampling, synthetic rewards, PPO batch."""
