"""Training and step builders of the port: AdamW, the train step,
checkpoints and the serving step builders."""
