version = "0.1.0.dev0"
