"""The training step: schedules, optimizer, fused update, train/eval step."""
