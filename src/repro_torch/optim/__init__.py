"""AdamW over parameter trees (`adamw`) and the int8 cross-pod gradient
mean with error feedback (`compress`)."""
