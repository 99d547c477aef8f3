"""Training losses on the rendered dict."""
