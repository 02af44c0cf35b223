"""Training utilities: AdamW and LR schedules over parameter trees."""
