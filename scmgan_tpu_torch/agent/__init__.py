"""The MPC agent: the planner, the host and batched play loops, the oracle."""
