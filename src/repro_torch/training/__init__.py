"""Training: AdamW, LR schedules, the train step with microbatching."""
