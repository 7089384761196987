"""Training of the port: the synthetic token stream (``data``), AdamW
with ZeRO-1 specs (``optimizer``) and the train and eval steps
(``train_step``)."""
